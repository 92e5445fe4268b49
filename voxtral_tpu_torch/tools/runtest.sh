#!/usr/bin/env bash
# End-to-end regression test of the PyTorch port (the reference runtest.sh
# analog, as tools/runtest.sh is the JAX package's): transcribe the bundled
# 60 s Italian clip with the port's CLI in batch and streaming modes and
# assert that golden substring phrases appear.  Substrings rather than an
# exact match because near-tied tokens can flip under accelerator FP
# (runtest.sh:22-26).
#
# Requires a model: VOXTRAL_MODEL_DIR must point at a directory with
# consolidated.safetensors + tekken.json.  Exits 0 with a SKIP message when
# it is unset.  VOXTRAL_DEVICE picks the CLI's --device (cuda, the default,
# or cpu).  VOXTRAL_SAMPLES_DIR holds the sample clips.
#
# A synthetic checkpoint (python -m voxtral_tpu_torch.tools.make_fake_ckpt
# writes a SYNTHETIC marker) skips the phrase phases and runs the fixture
# phase only: `make_golden check` against the fixtures under
# tests/fixtures/golden/ (exact token IDs against the port's own recorded
# runs, a word-level delta against the others).
set -euo pipefail

REPO="$(cd "$(dirname "$0")/../.." && pwd)"
MODEL_DIR="${VOXTRAL_MODEL_DIR:-}"
DEVICE="${VOXTRAL_DEVICE:-cuda}"
SAMPLES="${VOXTRAL_SAMPLES_DIR:-$REPO/samples}"
OGG="$SAMPLES/antirez_speaking_italian_short.ogg"
FIXDIR="$REPO/tests/fixtures/golden"
cd "$REPO"

if [[ -z "$MODEL_DIR" || ! -f "$MODEL_DIR/consolidated.safetensors" ]]; then
  echo "SKIP: set VOXTRAL_MODEL_DIR to a Voxtral checkpoint (a synthetic one" >&2
  echo "      from python -m voxtral_tpu_torch.tools.make_fake_ckpt drives" >&2
  echo "      the fixture phase)" >&2
  exit 0
fi

PHRASE_PHASES=1
if [[ -f "$MODEL_DIR/SYNTHETIC" ]]; then
  echo "NOTE: synthetic checkpoint — golden-phrase phases skipped" >&2
  PHRASE_PHASES=0
elif ! command -v ffmpeg >/dev/null; then
  echo "NOTE: no ffmpeg to decode the OGG sample — phrase phases skipped" >&2
  PHRASE_PHASES=0
fi

WAV=""
if [[ $PHRASE_PHASES == 1 ]]; then
  WAV=$(mktemp "${TMPDIR:-/tmp}/voxtral_test_XXXX.wav")
  trap 'rm -f "$WAV"' EXIT
  ffmpeg -loglevel quiet -y -i "$OGG" -ar 16000 -ac 1 "$WAV"
fi

# Golden phrases spanning beginning/middle/end of the clip — the reference's
# full list (runtest.sh:27-39), chosen there to avoid known near-tie flip
# points (Farmer[,|.]  personalmente[ ma|,]  distribuzione[ così|,]).
PHRASES=(
  "Forse qualcuno"
  "arance rosse"
  "Mr. Farmer"
  "agricoltore siciliano"
  "non conosco personalmente"
  "consigliarvelo"
  "pubblicizzare i suoi prodotti"
  "alcuno sponsor"
  "grande distribuzione"
  "mercati ortofrutticoli"
  "dove si trova"
)

check() {
  local out="$1" mode="$2" fails=0
  for p in "${PHRASES[@]}"; do
    if ! grep -qiF "$p" <<<"$out"; then
      echo "FAIL($mode): missing phrase: $p" >&2
      fails=$((fails + 1))
    fi
  done
  return $fails
}

if [[ $PHRASE_PHASES == 1 ]]; then
  echo "== batch mode (-i) ==" >&2
  OUT1=$(python -m voxtral_tpu_torch.cli -d "$MODEL_DIR" -i "$WAV" \
    --device "$DEVICE" --silent)
  check "$OUT1" batch

  echo "== streaming mode (--stdin -I 0.1) ==" >&2
  OUT2=$(ffmpeg -loglevel quiet -i "$WAV" -f s16le -ar 16000 -ac 1 - |
    python -m voxtral_tpu_torch.cli -d "$MODEL_DIR" --stdin -I 0.1 \
      --device "$DEVICE" --silent)
  check "$OUT2" streaming
fi

if compgen -G "$FIXDIR/*.json" >/dev/null; then
  echo "== fixture comparison (make_golden check) ==" >&2
  WAVDIR=$(mktemp -d "${TMPDIR:-/tmp}/voxtral_fixwav_XXXX")
  trap 'rm -rf "$WAV" "$WAVDIR"' EXIT
  [[ -n "$WAV" ]] && cp "$WAV" "$WAVDIR/antirez_speaking_italian_short.wav"
  for f in "$SAMPLES"/*.wav; do [[ -f "$f" ]] && cp "$f" "$WAVDIR/"; done
  python -m voxtral_tpu_torch.tools.make_golden check -d "$MODEL_DIR" \
    --fixtures "$FIXDIR" --wav-dir "$WAVDIR" --device "$DEVICE"
else
  echo "NOTE: no fixtures under $FIXDIR — record them once with" >&2
  echo "  python -m voxtral_tpu_torch.tools.make_golden record -d \$VOXTRAL_MODEL_DIR <wav>" >&2
  echo "  ./voxtral ... | python -m voxtral_tpu_torch.tools.make_golden ingest --name <clip>" >&2
fi

if [[ $PHRASE_PHASES == 1 ]]; then
  echo "OK: all golden phrases found in both modes"
else
  echo "OK: fixture phase complete (phrase phases need a real checkpoint)"
fi
