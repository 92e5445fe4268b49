"""Mic capture + live-stream feeding loop (L4' + main.c mic mode).

The reference captures via a macOS AudioQueue callback into a mutex-guarded
10 s ring buffer (voxtral_mic_macos.c:31-110) and drives the stream from a
main-thread loop with three behaviors (main.c:235-296):

  1. **Over-buffer catch-up** (:235-250): if capture has outrun processing
     by more than ~5 s, drop all but the newest ~1 s (with a warning) so the
     transcription stays near real time instead of drifting ever further
     behind.
  2. **Silence gating** (:261-288): voice feeds normally; the first ~600 ms
     of a silent stretch still feeds (so trailing words flush through), then
     the stream is flush()ed ONCE to emit the delayed tokens...
  3. **Skip-feed during extended silence** (:261-288): ...and after that
     flush nothing is fed until voice returns — no encoder work on dead air,
     and the stream content matches what a voice-activity-segmented feed
     would contain.

Here capture is a subprocess pipe (arecord/ffmpeg) drained by a reader
thread into the same kind of bounded ring; the loop logic is shared with the
tests through `run_mic_loop`, which takes any object with the MicCapture
read/available interface.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np

from .config import SAMPLE_RATE

# main.c:34-38 equivalents
OVERBUFFER_SKIP_S = 5.0     # catch-up triggers past this backlog
OVERBUFFER_KEEP_S = 1.0     # ...and drains down to this much
SILENCE_FEED_MS = 600       # silence fed through before the flush
DEFAULT_RMS_THRESHOLD = 0.01


class MicCapture:
    """Reader-thread + bounded ring over a raw s16le 16 kHz mono pipe
    (the AudioQueue-callback/ring analog, voxtral_mic_macos.c:31-110)."""

    def __init__(self, pipe, ring_seconds: float = 10.0):
        self._pipe = pipe
        self._cap = int(ring_seconds * SAMPLE_RATE)
        self._buf: list[np.ndarray] = []
        self._n = 0
        self._dropped = 0
        self._eof = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self):
        while True:
            raw = self._pipe.read(3200)  # 100 ms
            if not raw:
                with self._lock:
                    self._eof = True
                return
            pcm = np.frombuffer(raw[: len(raw) // 2 * 2], dtype="<i2")
            f = pcm.astype(np.float32) / 32768.0
            with self._lock:
                self._buf.append(f)
                self._n += len(f)
                while self._n > self._cap and self._buf:
                    head = self._buf.pop(0)
                    self._n -= len(head)
                    self._dropped += len(head)

    def available(self) -> int:
        with self._lock:
            return self._n

    def eof(self) -> bool:
        with self._lock:
            return self._eof and self._n == 0

    def read(self, max_samples: int) -> np.ndarray:
        """Non-blocking: up to max_samples of buffered audio (may be empty)."""
        out = []
        got = 0
        with self._lock:
            while self._buf and got < max_samples:
                head = self._buf[0]
                need = max_samples - got
                if len(head) <= need:
                    out.append(head)
                    got += len(head)
                    self._buf.pop(0)
                else:
                    out.append(head[:need])
                    self._buf[0] = head[need:]
                    got = max_samples
            self._n -= got
        if not out:
            return np.zeros(0, np.float32)
        return out[0] if len(out) == 1 else np.concatenate(out)


def run_mic_loop(
    stream,
    cap,
    drain,
    *,
    rms_threshold: float = DEFAULT_RMS_THRESHOLD,
    chunk_s: float = 0.1,
    overbuffer_skip_s: float = OVERBUFFER_SKIP_S,
    overbuffer_keep_s: float = OVERBUFFER_KEEP_S,
    silence_feed_ms: int = SILENCE_FEED_MS,
    sleep_fn=time.sleep,
    warn=lambda msg: print(msg, file=sys.stderr),
):
    """Drive `stream` from `cap` until EOF (main.c:235-296 semantics).

    cap needs .read(n)->float32[], .available()->int, .eof()->bool.
    drain() is called after every stream interaction to print tokens.
    """
    chunk_n = int(chunk_s * SAMPLE_RATE)
    silent_ms = 0.0
    flushed = False
    while True:
        # 1. over-buffer catch-up (main.c:235-250)
        backlog = cap.available()
        if backlog > overbuffer_skip_s * SAMPLE_RATE:
            skip = backlog - int(overbuffer_keep_s * SAMPLE_RATE)
            cap.read(skip)
            warn(
                f"[mic] processing fell {backlog / SAMPLE_RATE:.1f}s behind; "
                f"skipping {skip / SAMPLE_RATE:.1f}s of audio to catch up"
            )
        f = cap.read(chunk_n)
        if len(f) == 0:
            if cap.eof():
                break
            sleep_fn(0.01)
            continue
        rms = float(np.sqrt(np.mean(f * f)))
        if rms >= rms_threshold:
            # voice: feed, and re-arm the silence flush
            silent_ms = 0.0
            flushed = False
            stream.feed(f)
            drain()
            continue
        # silence (main.c:261-288)
        silent_ms += 1000.0 * len(f) / SAMPLE_RATE
        if silent_ms <= silence_feed_ms:
            stream.feed(f)
            drain()
        elif not flushed:
            stream.flush()
            drain()
            flushed = True
        # else: extended silence after the flush — skip the feed entirely
