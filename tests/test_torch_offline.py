"""The port's offline path against the JAX package's on tiny_config()
float32 with the same weights: padded mel, transcribe_offline_ids (exact
ids) and the CLI on a small model directory: -i --bulk-encode, and the
streaming modes (-i, --stdin, --from-mic with -I, --alt, --delay,
--monitor), whose stdout equals the JAX CLI stream's."""

import base64
import io
import json
import sys

import numpy as np
import pytest
import torch

from conftest import make_audio
from test_io import _torch_layout_checkpoint
from voxtral_tpu.config import tiny_config as jax_tiny
from voxtral_tpu.io.safetensors import write_safetensors
from voxtral_tpu.io.wav import write_wav
from voxtral_tpu.models.params import load_params as jax_load
from voxtral_tpu.runtime import engine as jeng
from voxtral_tpu.runtime import offline as joff
from voxtral_tpu.tokenizer import TekkenTokenizer as JTok
from voxtral_tpu_torch import cli
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.runtime import engine as teng
from voxtral_tpu_torch.runtime import offline as toff

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tengine(params_np):
    """The port's engine shaped like the JAX `engine` fixture."""
    return teng.VoxtralEngine(tiny_config(), from_jax_numpy(params_np),
                              buckets=(16, 4, 1), dec_kv_ring=64)


def test_padded_mel_equal(engine, tengine):
    for n in (16000, 16001, 12345):
        audio = make_audio(n / 16000.0, seed=1)
        np.testing.assert_array_equal(toff.padded_clip_mel(tengine, audio),
                                      joff.padded_clip_mel(engine, audio))


@pytest.mark.parametrize("seconds,seed", [(1.6, 23), (1.2, 5), (3.0, 7)])
def test_transcribe_offline_ids_equal(engine, tengine, seconds, seed):
    audio = make_audio(seconds, seed=seed)
    want = joff.transcribe_offline_ids(engine, audio)
    stats = {}
    got = toff.transcribe_offline_ids(tengine, audio, timings=stats)
    assert len(want) > 10
    assert got == want
    assert stats["adapter_finite"]
    assert stats["decode_steps"] >= len(got)


def test_adaptive_ring_and_decompose_equal():
    jc, tc = jax_tiny(), tiny_config()
    for n in (16000, 100_000, 480_000):
        assert teng.adaptive_dec_ring(tc, n) == jeng.adaptive_dec_ring(jc, n)
    for n in (0, 1, 37, 300):
        assert teng.decompose(n, teng.DEFAULT_BUCKETS) == \
            jeng.decompose(n, jeng.DEFAULT_BUCKETS)


# the CLI's engine sizes its encoder ring to the window plus the largest
# bucket (64), as the JAX CLI's does: 24 + 64 needs 128 slots
CLI_CFG = dict(enc_kv_ring=128)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """consolidated.safetensors in the reference layout + a byte tokenizer."""
    d = tmp_path_factory.mktemp("tiny_model")
    tensors = _torch_layout_checkpoint(jax_tiny(), np.random.default_rng(12))
    # zero the special ids' embedding rows: their logits are then 0 and the
    # greedy tokens land on text ids, so the transcript is not empty
    emb = "mm_streams_embeddings.embedding_module.tok_embeddings.weight"
    tensors[emb][:1000] = 0
    write_safetensors(str(d / "consolidated.safetensors"), tensors)
    vocab = [{"token_bytes": base64.b64encode(bytes([i])).decode()}
             for i in range(256)]
    (d / "tekken.json").write_text(json.dumps(
        {"config": {"default_num_special_tokens": 1000}, "vocab": vocab}))
    write_wav(str(d / "clip.wav"), make_audio(2.0, seed=31))
    return d


def test_cli_prints_the_jax_transcript(model_dir, capsys):
    from voxtral_tpu.io.wav import load_wav

    wav = str(model_dir / "clip.wav")
    samples = load_wav(wav)
    jcfg = jax_tiny()
    jengine = jeng.VoxtralEngine(
        jcfg, jax_load(str(model_dir), jcfg),
        tokenizer=JTok.load(str(model_dir / "tekken.json")),
        buckets=(64, 16, 4, 1), enc_kv_ring=128,   # the offline path has no
        dec_kv_ring=jeng.adaptive_dec_ring(jcfg, len(samples)))  # enc ring
    want = joff.transcribe_offline(jengine, samples)
    assert want

    rc = cli.main(["-d", str(model_dir), "-i", wav, "--bulk-encode",
                   "--device", "cpu"], cfg=tiny_config(**CLI_CFG))
    out = capsys.readouterr()
    assert rc == 0
    assert out.out == want + "\n"
    assert "Offline transcription:" in out.err
    assert "sequential" in out.err


@pytest.mark.parametrize("flag,quantize", [("--int8", True),
                                           ("--int4", "int4")])
def test_cli_quantized_prints_the_jax_transcript(model_dir, capsys, flag,
                                                 quantize):
    """-i --bulk-encode with --int8 / --int4: the transcript of the JAX
    package's engine quantized the same way (its CLI passes these flags to
    VoxtralEngine(quantize=...))."""
    from voxtral_tpu.io.wav import load_wav

    wav = str(model_dir / "clip.wav")
    samples = load_wav(wav)
    jcfg = jax_tiny()
    jengine = jeng.VoxtralEngine(
        jcfg, jax_load(str(model_dir), jcfg),
        tokenizer=JTok.load(str(model_dir / "tekken.json")),
        buckets=(64, 16, 4, 1), enc_kv_ring=128,
        dec_kv_ring=jeng.adaptive_dec_ring(jcfg, len(samples)),
        quantize=quantize)
    want = joff.transcribe_offline(jengine, samples)
    assert want

    rc = cli.main(["-d", str(model_dir), "-i", wav, "--bulk-encode", flag,
                   "--device", "cpu"], cfg=tiny_config(**CLI_CFG))
    out = capsys.readouterr()
    assert rc == 0
    assert out.out == want + "\n"


# the JAX CLI's decode mode for each of its flags (voxtral_tpu/cli.py)
JAX_MODE = {"--jacobi": "jacobi", "--no-jacobi": "sequential", None: "auto"}
_JAX_OUT: dict = {}


def _long_clip(model_dir):
    """A 5 s clip: the offline path then decodes a 64-row burst, which
    "auto" takes as a Jacobi burst."""
    path = model_dir / "clip5.wav"
    if not path.exists():
        write_wav(str(path), make_audio(5.0, seed=32))
    return str(path)


def _jax_cli_out(model_dir, wav, source, flag):
    """What the JAX CLI prints for `wav` with this decode flag: -i
    --bulk-encode through its engine and transcribe_offline, -i and
    --stdin (WAV bytes) through its stream and _drain."""
    from voxtral_tpu.io.wav import load_wav

    key = (wav, source == "bulk", flag)
    if key not in _JAX_OUT:
        samples = load_wav(wav)
        if source == "bulk":
            jcfg = jax_tiny()
            jengine = jeng.VoxtralEngine(
                jcfg, jax_load(str(model_dir), jcfg),
                tokenizer=JTok.load(str(model_dir / "tekken.json")),
                buckets=(64, 16, 4, 1), enc_kv_ring=128,
                dec_kv_ring=jeng.adaptive_dec_ring(jcfg, len(samples)),
                decode_mode=JAX_MODE[flag])
            _JAX_OUT[key] = joff.transcribe_offline(jengine, samples) + "\n"
        else:
            _JAX_OUT[key] = _jax_stream_out(
                model_dir, samples, _second_feeds(len(samples)),
                decode_mode=JAX_MODE[flag])
    return _JAX_OUT[key]


@pytest.mark.parametrize("flag", ["--jacobi", "--no-jacobi", None],
                         ids=["jacobi", "no-jacobi", "auto"])
@pytest.mark.parametrize("source", ["bulk", "stream", "stdin"])
def test_cli_decode_modes_print_the_jax_transcript(model_dir, capsys,
                                                   monkeypatch, source, flag):
    """--jacobi, --no-jacobi and the default "auto", offline with and
    without --bulk-encode and on --stdin (WAV bytes): stdout equals what
    the JAX CLI prints with the same flag, and stderr names the mode.  The
    default "auto" prints the JAX CLI's sequential transcript: on this
    config's 48-slot ring (the decoder window) a 64-row Jacobi window
    would overwrite keys its own queries read, which the JAX CLI's "auto"
    does and the port's decodes sequentially (ROADMAP.md section 3)."""
    import types

    wav = _long_clip(model_dir)
    want = _jax_cli_out(model_dir, wav, source, flag or "--no-jacobi")
    assert want.strip()
    argv = ["-d", str(model_dir), "--device", "cpu"] + ([flag] if flag
                                                        else [])
    if source == "stdin":
        monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(
            buffer=io.BytesIO(open(wav, "rb").read())))
        argv.append("--stdin")
    else:
        argv += ["-i", wav] + (["--bulk-encode"] if source == "bulk" else [])
    rc = cli.main(argv, cfg=tiny_config(**CLI_CFG))
    out = capsys.readouterr()
    assert rc == 0
    assert out.out == want
    assert f"Decoding: greedy, {JAX_MODE[flag]}" in out.err


def test_cli_refuses_without_cuda(model_dir, capsys, monkeypatch):
    """The default device is cuda: with none, the CLI says so and returns
    non-zero before it loads anything; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = str(model_dir / "clip.wav")
    for extra in (["-i", wav], ["-i", wav, "--bulk-encode"], ["--stdin"]):
        assert cli.main(["-d", str(model_dir)] + extra,
                        cfg=tiny_config()) == 1
        err = capsys.readouterr().err
        assert "no CUDA device; pass --device cpu to run on the CPU" in err
        assert "Loading" not in err


# --- the streaming modes ----------------------------------------------------

def _jax_stream_out(model_dir, samples, feeds, *, continuous=False,
                    interval=None, alt=None, delay=None,
                    decode_mode="auto"):
    """What the JAX CLI prints for a stream fed `feeds` (sample counts):
    its engine built as its CLI builds it (decode mode "auto" unless its
    flags say otherwise), and its own `_drain`."""
    import contextlib
    import io

    from voxtral_tpu import cli as jcli
    from voxtral_tpu.runtime.stream import VoxStream as JStream

    jcfg = jax_tiny(**CLI_CFG)
    ring = (jeng.adaptive_dec_ring(jcfg, len(samples)) if not continuous
            else 2048)
    eng = jeng.VoxtralEngine(
        jcfg, jax_load(str(model_dir), jcfg),
        tokenizer=JTok.load(str(model_dir / "tekken.json")),
        dec_kv_ring=ring, buckets=(64, 16, 4, 1), decode_mode=decode_mode)
    if delay is not None:
        eng.set_delay(delay)
    s = JStream(eng)
    if interval is not None:
        s.set_processing_interval(interval)
    if alt is not None:
        s.set_alt(4, alt)
    s.set_continuous(continuous)
    out, state = io.StringIO(), {"any": False}
    with contextlib.redirect_stdout(out):
        i = 0
        for n in feeds:
            s.feed(samples[i: i + n])
            jcli._drain(s, state, alt is not None)
            i += n
        s.finish()
        jcli._drain(s, state, alt is not None)
    return out.getvalue() + "\n"


def _second_feeds(n):
    return [16000] * (n // 16000) + ([n % 16000] if n % 16000 else [])


@pytest.mark.parametrize("extra,kw", [
    ([], {}),
    (["-I", "0.5", "--alt", "0.5"], {"interval": 0.5, "alt": 0.5}),
    (["--delay", "240", "--monitor"], {"delay": 240}),
])
def test_cli_streaming_prints_the_jax_transcript(model_dir, capsys, extra,
                                                 kw):
    """-i without --bulk-encode streams the clip 1 s at a time through
    VoxStream: stdout is what the JAX CLI's stream prints, with -I, --alt
    ([best|alt] groups), --delay and --monitor (symbols on stderr)."""
    from voxtral_tpu.io.wav import load_wav

    wav = str(model_dir / "clip.wav")
    samples = load_wav(wav)
    want = _jax_stream_out(model_dir, samples, _second_feeds(len(samples)),
                           **kw)
    assert want.strip()
    rc = cli.main(["-d", str(model_dir), "-i", wav, "--device", "cpu"]
                  + extra, cfg=tiny_config(**CLI_CFG))
    out = capsys.readouterr()
    assert rc == 0
    assert out.out == want
    assert "warmup bucket 64" in out.err and "Warm-up done" in out.err
    assert "Device memory:" in out.err and "enc ring 128" in out.err
    assert "Encoder:" in out.err
    if "--monitor" in extra:
        assert "▶" in out.err and "·" in out.err
    if "--alt" in extra:
        assert "[" in out.out


def test_cli_stdin_wav_and_raw_pcm(model_dir, capsys, monkeypatch):
    """--stdin with WAV bytes streams like -i (1 s feeds); raw s16le PCM
    runs in continuous mode, 4 bytes first, then 8192-byte reads."""
    import types

    from voxtral_tpu.io.wav import load_wav

    wav = model_dir / "clip.wav"
    samples = load_wav(str(wav))
    pcm = np.round(samples * 32768.0).clip(-32768, 32767).astype("<i2")
    np.testing.assert_array_equal(pcm.astype(np.float32) / 32768.0, samples)
    cases = (
        (wav.read_bytes(), _jax_stream_out(
            model_dir, samples, _second_feeds(len(samples)))),
        (pcm.tobytes(), _jax_stream_out(
            model_dir, samples, [2] + [4096] * (len(samples) // 4096 + 1),
            continuous=True)),
    )
    for data, want in cases:
        monkeypatch.setattr(sys, "stdin", types.SimpleNamespace(
            buffer=io.BytesIO(data)))
        rc = cli.main(["-d", str(model_dir), "--stdin", "--device", "cpu"],
                      cfg=tiny_config(**CLI_CFG))
        out = capsys.readouterr()
        assert rc == 0
        assert out.out == want and want.strip()


def test_cli_from_mic(model_dir, capsys, monkeypatch, tmp_path):
    """--from-mic: the capture command's s16le PCM goes through the mic
    loop (all of it is voice, so all of it is fed) in continuous mode."""
    from voxtral_tpu.io.wav import load_wav

    samples = load_wav(str(model_dir / "clip.wav"))
    raw = tmp_path / "mic.raw"
    raw.write_bytes(np.round(samples * 32768.0).astype("<i2").tobytes())
    cmd = [sys.executable, "-c",
           f"import sys; sys.stdout.buffer.write(open({str(raw)!r}, 'rb')"
           ".read())"]
    monkeypatch.setattr(cli, "_mic_command", lambda: cmd)
    want = _jax_stream_out(model_dir, samples, [1600] * 20, continuous=True)
    rc = cli.main(["-d", str(model_dir), "--from-mic", "--device", "cpu"],
                  cfg=tiny_config(**CLI_CFG))
    out = capsys.readouterr()
    assert rc == 0
    assert out.out == want and want.strip()
    assert "Capturing from mic" in out.err
    monkeypatch.setattr(cli, "_mic_command", lambda: None)
    assert cli.main(["-d", str(model_dir), "--from-mic", "--device", "cpu"],
                    cfg=tiny_config(**CLI_CFG)) == 1
    assert "No mic capture backend" in capsys.readouterr().err


# --- the JAX CLI's flags on the port's parser ---------------------------------

def _jax_parser():
    """The JAX CLI's parser, caught as its main() is about to parse."""
    import argparse

    from voxtral_tpu import cli as jcli

    class Caught(Exception):
        pass

    def grab(self, *args, **kwargs):
        raise Caught(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Caught) as caught:
            jcli.main([])
    return caught.value.args[0]


def test_cli_parses_every_jax_option():
    """Every option string of voxtral_tpu.cli parses on the port's parser
    (a JAX command line never exits 2 there as unrecognized), into the
    same destination."""
    port = cli.build_parser()
    n = 0
    for act in _jax_parser()._actions:
        for opt in act.option_strings:
            if opt in ("-h", "--help"):
                continue
            argv = [] if "-d" in act.option_strings else ["-d", "m"]
            argv.append(opt)
            if act.nargs != 0:
                argv.append("1" if act.type in (int, float) else "x")
            ns = port.parse_args(argv)
            assert hasattr(ns, act.dest), opt
            n += 1
    assert n >= 20


@pytest.mark.parametrize("extra", [["--bulk-encode"], []])
def test_cli_profile_writes_a_trace(model_dir, capsys, tmp_path, extra):
    """--profile DIR: the offline (--bulk-encode) and the streaming run
    each write one torch.profiler Chrome trace of the transcription into
    DIR."""
    trace_dir = tmp_path / "trace"
    rc = cli.main(["-d", str(model_dir), "-i", str(model_dir / "clip.wav"),
                   "--device", "cpu", "--profile", str(trace_dir)] + extra,
                  cfg=tiny_config(**CLI_CFG))
    err = capsys.readouterr().err
    assert rc == 0
    files = list(trace_dir.glob("*.json"))
    assert len(files) == 1 and f"Profile trace: {files[0]}" in err
    assert json.loads(files[0].read_text())["traceEvents"]


def test_cli_compile_cache_flags_change_nothing(model_dir, capsys, tmp_path):
    """--compile-cache DIR and --no-compile-cache are accepted, say once
    each that the port has no XLA compile cache, create nothing and leave
    the transcript as it is."""
    argv = ["-d", str(model_dir), "-i", str(model_dir / "clip.wav"),
            "--bulk-encode", "--device", "cpu"]
    assert cli.main(argv, cfg=tiny_config(**CLI_CFG)) == 0
    plain = capsys.readouterr()
    cache = tmp_path / "cache"
    assert cli.main(argv + ["--compile-cache", str(cache),
                            "--no-compile-cache"],
                    cfg=tiny_config(**CLI_CFG)) == 0
    out = capsys.readouterr()
    assert out.out == plain.out and out.out.strip()
    assert out.err.count("no XLA compile cache") == 2
    assert not cache.exists()
