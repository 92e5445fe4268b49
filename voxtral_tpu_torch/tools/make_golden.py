"""Record and replay fidelity fixtures of the port's engine.

PyTorch counterpart of tools/make_golden.py:

  record   run the port's engine on WAV files and write token-ID + text
           fixtures
  ingest   capture the C reference's stdout transcript as a text fixture
  check    re-run the engine and compare against the stored fixtures:
           exact token IDs for the port's own engine fixtures recorded in
           the same configuration, a word-level delta report for the
           others (the reference's text, the JAX engine's fixtures, another
           quantization rung); --quant int8/int4 reports the delta against
           the bf16 fixture

The port's fixtures say `"engine": "voxtral_tpu_torch"` and live in their
own files (`<clip>.torch_engine[.<quant>].json`), beside and never over
the JAX engine's `<clip>.engine.json`.  Engine fixtures carry the
checkpoint's fingerprint and the clip's sha256; `check` skips (never
fails) a fixture recorded on another checkpoint or another clip.

Usage:

    python -m voxtral_tpu_torch.tools.make_golden record -d MODEL_DIR
        [--quant bf16|int8|int4] [--name N] [--fixtures DIR] WAV...
    python -m voxtral_tpu_torch.tools.make_golden ingest --name N
        [--text-file F] [--fixtures DIR]
    python -m voxtral_tpu_torch.tools.make_golden check -d MODEL_DIR
        [--quant ...] [--fixtures DIR] [--wav-dir DIR] [--min-ratio R]
        [NAME...]

Every command that runs the engine takes `--device cuda|cpu` (default
cuda).  Fixtures default to tests/fixtures/golden/ of the checkout.
"""

from __future__ import annotations

import argparse
import difflib
import glob
import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_FIXDIR = os.path.join(REPO, "tests", "fixtures", "golden")
ENGINE = "voxtral_tpu_torch"
ENGINE_TAG = "torch_engine"     # the fixture file's tag (JAX: "engine")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def weights_fingerprint(model_dir: str) -> str:
    """Cheap checkpoint-identity hash: file name, size and the first 4 MiB
    of every *.safetensors in the dir (tensor data, not just the layout
    header: synthetic and real checkpoints share shapes).  The JAX tool's
    hash, so both engines' fixtures name a checkpoint alike."""
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(model_dir, "*.safetensors"))):
        h.update(os.path.basename(path).encode())
        h.update(str(os.path.getsize(path)).encode())
        with open(path, "rb") as f:
            h.update(f.read(4 << 20))
    return h.hexdigest()


def _fixture_path(fixdir: str, name: str, engine: str, quant: str) -> str:
    suffix = "" if quant == "bf16" else f".{quant}"
    return os.path.join(fixdir, f"{name}.{engine}{suffix}.json")


def _load_engine(model_dir: str, quant: str, dev, cfg=None):
    from ..config import full_config
    from ..models.params import load_params
    from ..runtime.engine import VoxtralEngine, adaptive_dec_ring
    from ..tokenizer import TekkenTokenizer

    cfg = cfg or full_config()
    params = load_params(model_dir, cfg, device=dev)
    tok = TekkenTokenizer.load(os.path.join(model_dir, "tekken.json"))
    return VoxtralEngine(
        cfg, params, tokenizer=tok,
        quantize=quant if quant != "bf16" else False,
        dec_kv_ring=adaptive_dec_ring(cfg, 16000 * 120),
    )


def _transcribe(engine, wav: str):
    """(token_ids, text) of one clip through the streaming state machine
    (the path runtest.sh drives)."""
    from ..io.wav import load_wav
    from ..runtime.stream import VoxStream

    s = VoxStream(engine)
    s.record_ids = True
    s.feed(load_wav(wav))
    s.finish()
    text = "".join(s.get()).strip()
    return s.generated_ids, text


def cmd_record(args, dev, cfg=None) -> int:
    os.makedirs(args.fixtures, exist_ok=True)
    engine = _load_engine(args.model_dir, args.quant, dev, cfg)
    for wav in args.files:
        name = args.name or os.path.splitext(os.path.basename(wav))[0]
        ids, text = _transcribe(engine, wav)
        path = _fixture_path(args.fixtures, name, ENGINE_TAG, args.quant)
        with open(path, "w") as f:
            json.dump(
                {
                    "name": name,
                    "audio_sha256": _sha256(wav),
                    "weights_fingerprint": weights_fingerprint(
                        args.model_dir),
                    "engine": ENGINE,
                    "quant": args.quant,
                    "token_ids": ids,
                    "text": text,
                },
                f,
            )
        print(f"wrote {path} ({len(ids)} tokens, {len(text)} chars)")
    return 0


def cmd_ingest(args) -> int:
    """The C reference's transcript (its stdout) as a text fixture: the
    reference prints text only, so that comparison is by text."""
    os.makedirs(args.fixtures, exist_ok=True)
    if args.text_file:
        with open(args.text_file) as f:
            text = f.read().strip()
    else:
        text = sys.stdin.read().strip()
    path = _fixture_path(args.fixtures, args.name, "reference", "bf16")
    with open(path, "w") as f:
        json.dump(
            {
                "name": args.name,
                "engine": "reference",
                "quant": "bf16",
                "token_ids": None,
                "text": text,
            },
            f,
        )
    print(f"wrote {path} ({len(text)} chars)")
    return 0


def _delta_report(name: str, base: str, other: str, label: str):
    sm = difflib.SequenceMatcher(a=base.split(), b=other.split())
    ratio = sm.ratio()
    print(f"  {name}: {label} word-level similarity {ratio:.1%}")
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag != "equal":
            print(
                f"    {tag}: {' '.join(base.split()[i1:i2])!r} -> "
                f"{' '.join(other.split()[j1:j2])!r}"
            )
    return ratio


def cmd_check(args, dev, cfg=None) -> int:
    fixtures = sorted(glob.glob(os.path.join(args.fixtures, "*.json")))
    if args.names:
        fixtures = [
            p for p in fixtures
            if any(os.path.basename(p).startswith(n + ".") for n in args.names)
        ]
    if not fixtures:
        print(
            f"SKIP: no fixtures under {args.fixtures} — generate them with "
            f"'make_golden record' (this engine) and/or "
            f"'make_golden ingest' (the C reference's stdout) on a "
            f"machine with the checkpoint"
        )
        return 0

    engine = None
    fp = weights_fingerprint(args.model_dir)
    fails = 0
    done: dict[str, tuple] = {}          # clip name -> (ids, text) this run
    for path in fixtures:
        with open(path) as f:
            fx = json.load(f)
        name = fx["name"]
        # engine fixtures are exact token-ID regressions, valid only against
        # the checkpoint that recorded them: skip on a mismatch
        fx_fp = fx.get("weights_fingerprint")
        if fx_fp is not None and fx_fp != fp:
            print(f"SKIP {os.path.basename(path)}: recorded on a different "
                  f"checkpoint ({fx_fp[:12]}... vs {fp[:12]}...) — re-record "
                  f"with 'make_golden record'")
            continue
        wav = args.wav_dir and os.path.join(args.wav_dir, name + ".wav")
        if not wav or not os.path.exists(wav):
            print(f"SKIP {os.path.basename(path)}: no {name}.wav under "
                  f"--wav-dir")
            continue
        # the fixture's token IDs belong to one exact clip: a renamed or
        # different wav would report a misleading FAIL
        fx_audio = fx.get("audio_sha256")
        if fx_audio is not None and _sha256(wav) != fx_audio:
            print(f"SKIP {os.path.basename(path)}: {name}.wav content does "
                  f"not match the fixture's audio_sha256")
            continue
        if name not in done:
            if engine is None:
                engine = _load_engine(args.model_dir, args.quant, dev, cfg)
            done[name] = _transcribe(engine, wav)
        ids, text = done[name]

        if (fx["engine"] == ENGINE and fx["quant"] == args.quant
                and fx.get("token_ids") is not None):
            # this engine in the same configuration: exact token IDs
            ref_ids = fx["token_ids"]
            n = sum(a == b for a, b in zip(ids, ref_ids))
            ok = ids == ref_ids
            print(f"{'OK  ' if ok else 'FAIL'} {os.path.basename(path)}: "
                  f"{n}/{len(ref_ids)} token IDs match")
            fails += 0 if ok else 1
        else:
            # the reference's text, the JAX engine, or another rung: delta
            label = f"{fx['engine']}/{fx['quant']} vs {ENGINE}/{args.quant}"
            ratio = _delta_report(os.path.basename(path), fx["text"], text,
                                  label)
            if fx["engine"] == "reference" and args.quant == "bf16" \
                    and ratio < args.min_ratio:
                print(f"FAIL {os.path.basename(path)}: similarity "
                      f"{ratio:.1%} < {args.min_ratio:.0%}")
                fails += 1
    if fails:
        print(f"{fails} fixture comparison(s) FAILED")
        return 1
    print("all fixture comparisons passed")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="make_golden",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("record")
    rec.add_argument("-d", "--model-dir", required=True)
    rec.add_argument("--quant", choices=("bf16", "int8", "int4"),
                     default="bf16")
    rec.add_argument("--name", help="fixture name (default: wav basename)")
    rec.add_argument("--fixtures", default=DEFAULT_FIXDIR)
    rec.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    rec.add_argument("files", nargs="+")

    ing = sub.add_parser("ingest")
    ing.add_argument("--name", required=True)
    ing.add_argument("--text-file", help="reference stdout (default: stdin)")
    ing.add_argument("--fixtures", default=DEFAULT_FIXDIR)

    chk = sub.add_parser("check")
    chk.add_argument("-d", "--model-dir", required=True)
    chk.add_argument("--quant", choices=("bf16", "int8", "int4"),
                     default="bf16")
    chk.add_argument("--fixtures", default=DEFAULT_FIXDIR)
    chk.add_argument("--wav-dir", default=None,
                     help="directory holding <name>.wav for each fixture")
    chk.add_argument("--min-ratio", type=float, default=0.9,
                     help="min word similarity vs a reference text fixture")
    chk.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    chk.add_argument("names", nargs="*")
    return p


def main(argv=None, cfg=None) -> int:
    """Runs one command; `cfg` (default full_config()) lets tests and the
    smoke run drive a smaller or shallower checkpoint."""
    from . import pick_device

    args = build_parser().parse_args(argv)
    if args.cmd == "ingest":
        return cmd_ingest(args)
    dev = pick_device(args.device, "golden")
    if dev is None:
        return 1
    fn = cmd_record if args.cmd == "record" else cmd_check
    return fn(args, dev, cfg)


if __name__ == "__main__":
    sys.exit(main())
