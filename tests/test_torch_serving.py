"""parallel/serving.py and the decode-step row write of the port against
the JAX package on tiny_config() float32 with the same weights: the plain
row write bit for bit against the Pallas kernel (interpret mode), the fp8
overflow divergence, and batched prefill + burst decode at B=3 on every rung
of the dtype ladder (token ids exactly equal), and the batched streaming
encoder calls and BatchedTranscriber at B=3."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_audio
from voxtral_tpu.models import decoder as jdec
from voxtral_tpu.models import quant as jq
from voxtral_tpu.ops.ring import _rows_write_batched
from voxtral_tpu.parallel import serving as jsv
from voxtral_tpu_torch.config import tiny_config
from voxtral_tpu_torch.models import decoder as tdec
from voxtral_tpu_torch.models.params import from_jax_numpy
from voxtral_tpu_torch.ops.ring import (
    ring_rows_write,
    ring_rows_write_plain,
    ring_write,
    to_ring_dtype,
)
from voxtral_tpu_torch.parallel import serving as tsv

torch.set_num_threads(1)

RING_DTYPES = [("float32", torch.float32), ("bfloat16", torch.bfloat16),
               ("float8_e4m3fn", torch.float8_e4m3fn)]


def _bits(x) -> np.ndarray:
    """Raw bytes of a torch tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _rows_case(jdt, tdt, scale=1.0, fn=ring_rows_write_plain):
    """One row write per stream into layer 1 of [5, 3, 2, 64, 8] rings, in
    JAX (the Pallas kernel) and in the port (`fn`): (JAX rings, port rings,
    rows, positions)."""
    b, n_layers, kh, cap, d = 5, 3, 2, 64, 8
    rng = np.random.default_rng(9)
    ring = [jnp.asarray(rng.standard_normal((b, n_layers, kh, cap, d)),
                        jnp.float32).astype(jdt) for _ in range(2)]
    rows = [(rng.standard_normal((b, kh, d)) * scale).astype(np.float32)
            for _ in range(2)]
    pos = np.array([0, 31, 63, 64 + 5, 3 * 64 + 40], np.int32)  # wraps
    jout = _rows_write_batched(ring[0], ring[1], jnp.asarray(rows[0]),
                               jnp.asarray(rows[1]), 1, jnp.asarray(pos))
    tk, tv = (from_jax_numpy(np.asarray(r)) for r in ring)
    assert tk.dtype == tdt
    tout = fn(tk, tv, torch.from_numpy(rows[0]), torch.from_numpy(rows[1]),
              1, torch.from_numpy(pos))
    assert tout[0] is tk and tout[1] is tv             # written in place
    return jout, tout, rows, pos


@pytest.mark.parametrize("fn", [ring_rows_write_plain, ring_rows_write],
                         ids=["plain", "dispatch"])
@pytest.mark.parametrize("jdt,tdt", RING_DTYPES, ids=[n for n, _ in RING_DTYPES])
def test_ring_rows_write_matches_pallas(jdt, tdt, fn):
    """|rows| < 448: both rings bit-equal after the write, in f32, bf16 and
    fp8, with positions that wrap the 64-slot ring; the dispatching entry
    point takes the plain version for CPU tensors and launches nothing."""
    n0 = ring_rows_write.launches
    jout, tout, _, _ = _rows_case(jdt, tdt, fn=fn)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(_bits(t), _bits(j))
    assert ring_rows_write.launches == n0


def test_fp8_row_overflow_saturates_in_port_and_is_nan_in_jax():
    """The one known divergence from the reference (ROADMAP.md section 3):
    an fp8 row value that rounds past 448 is +-448 in the port (its
    `to_ring_dtype`, like the kernel's __NV_SATFINITE cast) and NaN in the
    JAX package (ml_dtypes)."""
    jout, tout, rows, pos = _rows_case("float8_e4m3fn", torch.float8_e4m3fn,
                                       scale=1000.0)
    for i in range(2):                                    # K and V
        for b, slot in enumerate(pos % 64):
            row = rows[i][b]                              # [KH, D]
            got = tout[i][b, 1, :, slot, :].float().numpy()
            want = np.asarray(jout[i][b, 1, :, slot, :].astype(jnp.float32))
            over = np.abs(row) > 464      # past 448's rounding interval
            assert over.any()
            np.testing.assert_array_equal(got[over],
                                          np.sign(row[over]) * 448.0)
            assert np.isnan(want[over]).all()
            # below the overflow both casts agree bit for bit
            np.testing.assert_array_equal(got[~over], want[~over])
    # the single-value form of the same fact, and the prefill's chunk write
    x = np.array([500.0, -1000.0, 449.0, 464.0, float("inf"), 0.3],
                 np.float32)
    np.testing.assert_array_equal(
        to_ring_dtype(torch.from_numpy(x), torch.float8_e4m3fn)
        .float().numpy(), [448.0, -448.0, 448.0, 448.0, 448.0, 0.3125])
    j = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn).astype(
        jnp.float32))
    assert np.isnan(j[[0, 1, 4]]).all()
    assert (j[[2, 3, 5]] == [448.0, 448.0, 0.3125]).all()
    ring = torch.zeros((1, 1, 8, 6), dtype=torch.float8_e4m3fn)
    ring_write(ring, torch.from_numpy(x).reshape(1, 1, 1, 6).expand(
        1, 3, 1, 6), torch.tensor([6]))
    assert ring.float().abs().max() == 448.0


# --- batched prefill + burst decode at B=3 on the dtype ladder --------------

RUNGS = {   # name: (ring dtype, decoder quantization bits or None)
    "f32": ("float32", None),
    "fp8": ("float8_e4m3fn", None),
    "int8_fp8": ("float8_e4m3fn", 8),
    "int4_fp8": ("float8_e4m3fn", 4),
}
B, CAP, BURST, N_BURSTS = 3, 64, 16, 2


def _rung(name, params, tparams):
    """(JAX cfg, JAX decoder tree, port cfg, port decoder tree): the JAX
    tree quantized in JAX and carried across bit for bit."""
    kv, bits = RUNGS[name]
    from voxtral_tpu.config import tiny_config as jax_tiny

    jcfg, tcfg = jax_tiny().replace(kv_dtype=kv), tiny_config().replace(
        kv_dtype=kv)
    if bits is None:
        return jcfg, params["decoder"], tcfg, tparams["decoder"]
    jp = jq.quantize_params(params, encoder=False, bits=bits)
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, jp["decoder"], tcfg, tp["decoder"]


def _inputs(cfg):
    rng = np.random.default_rng(17)
    pl = cfg.prompt_len - 1
    emb = rng.standard_normal((B, pl, cfg.decoder.dim)).astype(np.float32)
    chunks = 3.0 * rng.standard_normal(
        (B, BURST * N_BURSTS, cfg.decoder.dim)).astype(np.float32)
    return pl, emb, chunks


def _run_jax(jcfg, jdp):
    pl, emb, chunks = _inputs(jcfg)
    ada = jdec.ada_scales(jdp, jcfg)
    cache = jsv.batched_dec_cache(jcfg, B, CAP)
    cache = jsv.bprefill(jdp, jcfg, jnp.asarray(emb), cache,
                         jnp.zeros((B,), jnp.int32), ada)
    prev = jnp.full((B,), 32, jnp.int32)
    toks = []
    for i in range(N_BURSTS):
        t, _, _, _, cache = jsv.bdecode_burst(
            jdp, jcfg, jnp.asarray(chunks[:, i * BURST:(i + 1) * BURST]),
            prev, cache, jnp.full((B,), pl + i * BURST, jnp.int32), ada)
        toks.append(np.asarray(t))
        prev = t[:, -1]
    return np.concatenate(toks, axis=1), cache


def _run_port(tcfg, tdp, streams=slice(None)):
    pl, emb, chunks = _inputs(tcfg)
    emb, chunks = emb[streams], chunks[streams]
    bsz = emb.shape[0]
    ada = tdec.ada_scales(tdp, tcfg)
    cache = tsv.batched_dec_cache(tcfg, bsz, CAP)
    assert cache.k.dtype == tcfg.kvdtype and cache.k.shape[:2] == (bsz, 2)
    out = tsv.bprefill(tdp, tcfg, torch.from_numpy(emb), cache,
                       torch.zeros(bsz, dtype=torch.int32), ada)
    assert out is cache                                # updated in place
    prev = torch.full((bsz,), 32, dtype=torch.int32)
    toks = []
    for i in range(N_BURSTS):
        t, _, _, _, cache = tsv.bdecode_burst(
            tdp, tcfg,
            torch.from_numpy(chunks[:, i * BURST:(i + 1) * BURST].copy()),
            prev, cache, torch.full((bsz,), pl + i * BURST,
                                    dtype=torch.int32), ada)
        toks.append(t.numpy())
        prev = t[:, -1]
    return np.concatenate(toks, axis=1), cache


@pytest.mark.parametrize("rung", list(RUNGS))
def test_batched_serving_ids_equal_jax(params, params_np, rung):
    """bprefill + two bdecode_bursts of 16 steps at B=3 on a 64-slot ring
    that wraps: token ids exactly equal to JAX sv.bprefill/sv.bdecode_burst
    on the same (JAX-quantized, carried) weights; caches equal to f32
    rounding, read in f32."""
    jcfg, jdp, tcfg, tdp = _rung(rung, params, from_jax_numpy(params_np))
    want, jc = _run_jax(jcfg, jdp)
    got, tc = _run_port(tcfg, tdp)
    assert got.shape == (B, BURST * N_BURSTS) and got.dtype == np.int32
    assert (tcfg.prompt_len - 1) + BURST * N_BURSTS > CAP   # the ring wrapped
    np.testing.assert_array_equal(got, want)
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(
            t.float().numpy(), np.asarray(j.astype(jnp.float32)),
            rtol=1e-5, atol=1e-5 if rung == "f32" else 0.07)


@pytest.mark.parametrize("rung", list(RUNGS))
def test_batched_rows_equal_single_stream(params, params_np, rung):
    """Each stream of the B=3 run gives exactly the ids of the same stream
    run alone at B=1, and its cache to f32 rounding (the CPU GEMM sums a
    3-row product in another order than a 1-row one; an fp8 ring may then
    round one element to its neighbour)."""
    _, _, tcfg, tdp = _rung(rung, params, from_jax_numpy(params_np))
    toks, cache = _run_port(tcfg, tdp)
    for s in range(B):
        t1, c1 = _run_port(tcfg, tdp, streams=slice(s, s + 1))
        np.testing.assert_array_equal(t1[0], toks[s])
        for one, batched in ((c1.k[0], cache.k[s]), (c1.v[0], cache.v[s])):
            np.testing.assert_allclose(
                one.float().numpy(), batched.float().numpy(), rtol=1e-5,
                atol=1e-5 if rung == "f32" else 0.07)


def test_bdecode_burst_attention_paths_agree(params_np):
    """The f32 and the fp8 ring both take the flash path under
    attn_impl="auto" (the port's rule: fp8 rings take the kernel too);
    forcing "xla" on either ring gives the same ids (the two paths compute
    the same function)."""
    tp = from_jax_numpy(params_np)["decoder"]
    for kv in ("float32", "float8_e4m3fn"):
        base = tiny_config().replace(kv_dtype=kv)
        ids = {}
        for impl in ("auto", "xla"):
            cfg = base.replace(decoder=dataclasses.replace(base.decoder,
                                                           attn_impl=impl))
            ids[impl] = _run_port(cfg, tp)[0]
        np.testing.assert_array_equal(ids["auto"], ids["xla"])
    for dt in (torch.float32, torch.float8_e4m3fn):
        assert tdec._use_flash(base.decoder, torch.zeros(1, dtype=dt))


# --- the lockstep batched streaming transcriber at B=3 ----------------------

def _stream_mels(seconds=2.0, seeds=(61, 62, 63)):
    """Padded mel of each clip, cut to the shortest: [B, T, 128]."""
    from voxtral_tpu_torch.runtime.offline import padded_clip_mel

    eng = SimpleNamespace(delay_tokens=tiny_config().delay_tokens)
    audios = [make_audio(seconds, seed=s) for s in seeds]
    mels = [padded_clip_mel(eng, a) for a in audios]
    n = min(m.shape[0] for m in mels)
    return audios, np.stack([m[:n] for m in mels])


@pytest.fixture(scope="module")
def transcriber_runs(params, params_np, tiny_tokenizer):
    """(JAX BatchedTranscriber tokens, port tokens, port transcriber, port
    engine) at B=3 with 48-frame feeds, f32."""
    from voxtral_tpu.config import tiny_config as jax_tiny
    from voxtral_tpu.runtime.engine import VoxtralEngine as JEngine
    from voxtral_tpu_torch.runtime.engine import VoxtralEngine as TEngine
    from voxtral_tpu_torch.tokenizer import TekkenTokenizer

    audios, mel = _stream_mels()
    je = JEngine(jax_tiny(), params, tokenizer=tiny_tokenizer,
                 buckets=(16, 4, 1), enc_kv_ring=64, dec_kv_ring=64)
    want = jsv.BatchedTranscriber(je, batch=B, dec_kv_ring=64).transcribe(
        mel, interval_frames=48)
    te = TEngine(tiny_config(), from_jax_numpy(params_np),
                 tokenizer=TekkenTokenizer([bytes([i]) for i in range(256)],
                                           1000),
                 buckets=(16, 4, 1), enc_kv_ring=64, dec_kv_ring=64)
    tr = tsv.BatchedTranscriber(te, batch=B, dec_kv_ring=64)
    got = tr.transcribe(torch.from_numpy(mel), interval_frames=48)
    return audios, want, got, tr, te


def test_batched_transcriber_equals_jax(transcriber_runs):
    """Every stream's token ids equal the JAX BatchedTranscriber's; the
    encoder ran through bencode in chunks of T > 1 (the flash-encode
    path)."""
    _, want, got, tr, _ = transcriber_runs
    assert [len(t) for t in want] == [len(t) for t in got]
    assert got == want
    assert min(len(t) for t in got) > 10
    assert tr.n_enc_chunk_calls > 0 and tr.decode_steps > 0
    assert tr.enc_cache.k.shape[0] == B


def test_batched_transcriber_equals_single_stream(transcriber_runs):
    """Each stream's text tokens are a prefix-equal match of the port's
    single VoxStream on the same clip (tests/test_batched.py's check)."""
    from voxtral_tpu_torch.runtime.stream import VoxStream

    audios, _, got, _, te = transcriber_runs
    tok = te.tokenizer
    for i, audio in enumerate(audios):
        s = VoxStream(te)
        s.set_processing_interval(0.1)
        s.feed(audio)
        s.finish()
        ref = s.get()
        text = [tok.decode(t) for t in got[i]
                if tok.classify(t) == tok.TOK_TEXT]
        m = min(len(text), len(ref))
        assert m > 0
        assert text[:m] == ref[:m], f"stream {i}"


def test_batched_encoder_calls_equal_jax(params, params_np):
    """bconv0 -> bconv1 -> bencode -> badapter at B=3 with per-stream
    encoder positions (the port's calls are batched-first; JAX vmaps)."""
    from voxtral_tpu.config import tiny_config as jax_tiny

    jcfg, tcfg = jax_tiny(), tiny_config()
    tp = from_jax_numpy(params_np)
    rng = np.random.default_rng(21)
    mel = rng.standard_normal((B, 16, 128)).astype(np.float32)
    pos = np.array([0, 40, 130], np.int32)     # the third ring has wrapped
    jc0, _ = jsv.bconv0(params["encoder"], jcfg, jnp.asarray(mel),
                        jnp.zeros((B, 2, 128), jnp.float32))
    tc0, _ = tsv.bconv0(tp["encoder"], tcfg, torch.from_numpy(mel),
                        torch.zeros((B, 2, 128)))
    jc1, _ = jsv.bconv1(params["encoder"], jcfg, jc0,
                        jnp.zeros((B, 2, 16), jnp.float32))
    tc1, _ = tsv.bconv1(tp["encoder"], tcfg, tc0, torch.zeros((B, 2, 16)))
    jcache = jsv.batched_enc_cache(jcfg, B, 64)
    tcache = tsv.batched_enc_cache(tcfg, B, 64)
    assert tuple(tcache.k.shape) == tuple(jcache.k.shape)
    jy, jcache = jsv.bencode(params["encoder"], jcfg, jc1, jcache,
                             jnp.asarray(pos))
    ty, tcache = tsv.bencode(tp["encoder"], tcfg, tc1, tcache,
                             torch.from_numpy(pos))
    ja = jsv.badapter(params["adapter"], jcfg, jy)
    ta = tsv.badapter(tp["adapter"], tcfg, ty)
    for t, j in ((tc1, jc1), (ty, jy), (ta, ja), (tcache.k, jcache.k)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
