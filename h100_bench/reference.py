"""The plain reference of Voxtral-Mini-4B-Realtime that decides `correct`.

Plain PyTorch, float32 on the card with TF32 off.  It imports nothing of
the program (`voxtral_tpu_torch`) nor of the JAX package: it was written
from the model's description, after the port's own float32 oracle
(`voxtral_tpu_torch/tools/oracle.py`), and is frozen here so that a later
change of the program cannot change the yardstick.

It takes the raw inputs the benchmark made (the clips' samples, the seeded
weights) and works out again what the program derives from them: the log
mel with the offline padding schedule, and in a configuration with int8
decoder weights the per-row int8 quantization.  It is a full-sequence
model (no cache, no ring, dense masks), teacher-forced on the tokens the
program served.

`precision` is what the configuration states for the stored tensors:
  decoder_weights  "bf16" (the weights as made) | "int8" (per-row
                   symmetric, max |w| / 127, round half to even)
  decoder_kv       "bf16" (no rounding of K/V) | "e4m3" (K after RoPE and V
                   rounded to float8 e4m3fn, saturating, as stored rings)
`control` computes the reference one step lower, in the program's place:
  "fp8"   every product's weight and input rounded to e4m3 with a scale
          per row (the step below bf16)
  "int4"  the decoder's int8 tensors quantized to int4 instead, a scale per
          group of 128 inputs (the step below int8), and the encoder's and
          adapter's bf16 products in fp8 as above (the step below bf16)
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
HOP = 160
N_FFT = 400
N_MEL = 128
LOG_MEL_MAX = 1.5
SAMPLES_PER_TOKEN = 1280          # 16 kHz / 12.5 tokens per second
LEFT_PAD_TOKENS = 32
RIGHT_PAD_EXTRA_TOKENS = 10       # offline streaming buffer
TOKEN_BOS, TOKEN_EOS, TOKEN_PAD = 1, 2, 32
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products stay float32: TF32 off for cuBLAS and cuDNN."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, dnn.allow_tf32)
    mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# log mel, offline padding schedule
# ---------------------------------------------------------------------------

def _slaney_mel(f):
    f = torch.as_tensor(f, dtype=torch.float64)
    lin = 3.0 * f / 200.0
    log = 15.0 + torch.log(torch.clamp(f, min=1e-30) / 1000.0) * (
        27.0 / math.log(6.4))
    return torch.where(f >= 1000.0, log, lin)


def _slaney_hz(m):
    lin = 200.0 * m / 3.0
    log = 1000.0 * torch.exp((math.log(6.4) / 27.0) * (m - 15.0))
    return torch.where(m >= 15.0, log, lin)


def mel_filterbank(device) -> torch.Tensor:
    """[201, 128] float64 Slaney filterbank over 0-8 kHz, area-normalized."""
    n_freq = N_FFT // 2 + 1
    fft_f = torch.linspace(0, SAMPLE_RATE // 2, n_freq, dtype=torch.float64)
    mels = torch.linspace(float(_slaney_mel(0.0)), float(_slaney_mel(8000.0)),
                          N_MEL + 2, dtype=torch.float64)
    hz = _slaney_hz(mels)
    diff = hz[1:] - hz[:-1]
    slopes = hz[None, :] - fft_f[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    fb = torch.clamp(torch.minimum(down, up), min=0.0)
    fb = fb * (2.0 / (hz[2:] - hz[:-2]))[None, :]
    return fb.to(device)


def padded_mel_frames(n_samples: int, delay_tokens: int) -> int:
    align = (-n_samples) % SAMPLES_PER_TOKEN
    right = align + (delay_tokens + 1 + RIGHT_PAD_EXTRA_TOKENS) \
        * SAMPLES_PER_TOKEN
    total = N_FFT // 2 + LEFT_PAD_TOKENS * SAMPLES_PER_TOKEN + n_samples \
        + right + N_FFT // 2
    frames = (total - N_FFT) // HOP      # the last STFT frame is dropped
    return frames - frames % 8


@torch.no_grad()
def log_mel(samples: torch.Tensor, frames: int) -> torch.Tensor:
    """The first `frames` log-mel frames [frames, 128] float32 of a clip
    behind 200 zeros (the centred STFT's left edge) and 32 tokens of
    silence, zeros after its end: periodic Hann(400), hop 160; power ->
    Slaney mel -> log10 clamped at 1e-10 and at 1.5 - 8 -> (x + 4) / 4."""
    x = samples.to(torch.float64)
    n = x.shape[0]
    left = N_FFT // 2 + LEFT_PAD_TOKENS * SAMPLES_PER_TOKEN
    total = (frames - 1) * HOP + N_FFT
    sig = torch.zeros(max(total, left + n), dtype=torch.float64,
                      device=x.device)
    sig[left: left + n] = x
    win = sig[:total].unfold(0, N_FFT, HOP)                # [frames, 400]
    i = torch.arange(N_FFT, dtype=torch.float64, device=x.device)
    hann = 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / N_FFT))
    spec = torch.fft.rfft(win * hann, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ mel_filterbank(x.device)
    log = torch.log10(torch.clamp(mel, min=1e-10))
    log = torch.clamp(log, min=LOG_MEL_MAX - 8.0)
    return ((log + 4.0) / 4.0).float()


def padded_mel(samples: torch.Tensor, delay_tokens: int) -> torch.Tensor:
    """[n] float32 samples -> [Tm, 128] log mel on the offline schedule:
    after the clip, silence to a whole token plus delay + 11 tokens and
    the STFT's 200-sample right edge, the last frame dropped, Tm cut to a
    multiple of 8 (`log_mel`)."""
    return log_mel(samples, padded_mel_frames(samples.shape[0],
                                              delay_tokens))


def live_mel(samples: torch.Tensor) -> torch.Tensor:
    """The log mel a live stream encodes of the samples fed so far: every
    frame whose window they fill, no right padding, cut to a multiple of 8
    (whole adapter rows; `log_mel`)."""
    left = N_FFT // 2 + LEFT_PAD_TOKENS * SAMPLES_PER_TOKEN
    frames = (left + samples.shape[0] - N_FFT) // HOP + 1
    return log_mel(samples, frames - frames % 8)


# ---------------------------------------------------------------------------
# precisions
# ---------------------------------------------------------------------------

def e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3fn, saturating at +-448, back in float32."""
    return x.clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).float()


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows rounded to e4m3 with one scale a row (max |x| to 448)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return e4m3(x / s) * s


def int8_rows(w: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric int8 of [out, in], dequantized: s = max |w| / 127,
    round half to even, clip +-127."""
    wf = w.float()
    s = (wf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp(min=1e-12)
    return torch.clamp(torch.round(wf / s), -127, 127) * s


def int4_groups(w: torch.Tensor, group: int = 128) -> torch.Tensor:
    """Symmetric int4 of [out, in] with a scale per group of `group` inputs
    (max |w| / 7, clip +-7; one group a row where `group` does not divide
    the row), dequantized."""
    wf = w.float()
    o, i = wf.shape
    group = group if i % group == 0 else i
    g = wf.reshape(o, i // group, group)
    s = (g.abs().amax(dim=-1, keepdim=True) / 7.0).clamp(min=1e-12)
    return (torch.clamp(torch.round(g / s), -7, 7) * s).reshape(o, i)


class Precision:
    """How the reference rounds stored tensors and products (module
    docstring)."""

    def __init__(self, decoder_weights: str = "bf16",
                 decoder_kv: str = "bf16", control: str | None = None):
        if decoder_weights not in ("bf16", "int8"):
            raise ValueError(f"decoder_weights {decoder_weights!r}")
        if decoder_kv not in ("bf16", "e4m3"):
            raise ValueError(f"decoder_kv {decoder_kv!r}")
        if control not in (None, "fp8", "int4"):
            raise ValueError(f"control {control!r}")
        self.decoder_weights = decoder_weights
        self.decoder_kv = decoder_kv
        self.control = control

    def dec_weight(self, w: torch.Tensor) -> torch.Tensor:
        """A decoder product's (or the tied table's) weight in float32."""
        if self.decoder_weights == "int8":
            if self.control == "int4":
                return int4_groups(w)
            return int8_rows(w)
        return w.float()

    def linear(self, x, w, b=None, bf16_weight: bool = True):
        """x [..., in] @ w[out, in].T (+ b), float32.  A control rounds both
        operands of a product whose stated weights are bf16 to e4m3 by row
        first (every product under "fp8", the encoder's and adapter's under
        "int4")."""
        w = w.float()
        if self.control == "fp8" or (self.control == "int4"
                                     and bf16_weight):
            x, w = fp8_rows(x), fp8_rows(w)
        return F.linear(x, w, None if b is None else b.float())

    def dec_linear(self, x, w):
        """A decoder product (or the tied logits) of weight w as stated."""
        return self.linear(x, self.dec_weight(w),
                           bf16_weight=self.decoder_weights == "bf16")

    def kv(self, x):
        return e4m3(x) if self.decoder_kv == "e4m3" else x


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x, positions, theta):
    """Interleaved RoPE over [T, H, D]."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device).float() / d))
    ang = positions.float()[:, None] * inv                  # [T, D/2]
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], -1).flatten(-2)


def attention(q, k, v, window, block: int = 1024):
    """Causal attention of q [T, H, D] over k/v [T, KH, D] (grouped
    heads), keys j with i - window < j <= i; queries in blocks."""
    t, h, d = q.shape
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).transpose(0, 1)      # [H, T, D]
    vv = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    j = torch.arange(t, device=q.device)
    for lo in range(0, t, block):
        hi = min(lo + block, t)
        i = torch.arange(lo, hi, device=q.device)[:, None]
        mask = (j[None, :] <= i) & (j[None, :] > i - window)
        s = q[lo:hi].transpose(0, 1) @ kk.transpose(1, 2) / math.sqrt(d)
        s = s.masked_fill(~mask, float("-inf"))
        out[lo:hi] = (s.softmax(-1) @ vv).transpose(0, 1)
    return out


# ---------------------------------------------------------------------------
# encoder + adapter
# ---------------------------------------------------------------------------

@torch.no_grad()
def encode(params, model: dict, mel: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """mel [Tm, 128] -> adapter rows [Tm // 8, decoder dim] float32."""
    e = model["encoder"]
    enc = params["encoder"]
    dim, k = e["dim"], 3

    def conv(x, w_im2col, b, stride):
        # causal: a 2-frame zero tail; output j reads rows stride*j + stride-1
        # .. + 2 of the tail-prepended input
        xin = torch.cat([x.new_zeros(2, x.shape[1]), x])
        start = stride - 1
        n = (xin.shape[0] - start - k) // stride + 1
        cols = torch.cat([xin[start + i: start + i + stride * (n - 1) + 1:
                              stride] for i in range(k)], dim=-1)
        return F.gelu(prec.linear(cols, w_im2col.t(), b))

    h = conv(mel.float(), enc["conv0_w"], enc["conv0_b"], 1)
    h = conv(h, enc["conv1_w"], enc["conv1_b"], 2)
    t = h.shape[0]
    pos = torch.arange(t, device=h.device)
    lp = enc["layers"]
    hd, nh = e["head_dim"], e["n_heads"]
    qd = nh * hd
    for i in range(e["n_layers"]):
        x = rms_norm(h, lp["attn_norm"][i], e["norm_eps"])
        qkv = prec.linear(x, lp["wqkv"][i], lp["bqkv"][i])
        q = rope(qkv[:, :qd].view(t, nh, hd), pos, e["rope_theta"])
        kk = rope(qkv[:, qd:2 * qd].view(t, nh, hd), pos, e["rope_theta"])
        v = qkv[:, 2 * qd:].view(t, nh, hd)
        a = attention(q, kk, v, e["window"]).reshape(t, qd)
        h = h + prec.linear(a, lp["wo"][i], lp["bo"][i])
        x = rms_norm(h, lp["ffn_norm"][i], e["norm_eps"])
        g13 = prec.linear(x, lp["w13"][i])
        hid = g13.shape[1] // 2
        h = h + prec.linear(F.silu(g13[:, :hid]) * g13[:, hid:],
                            lp["w2"][i], lp["b2"][i])
    h = rms_norm(h, enc["final_norm"], e["norm_eps"])
    ad = params["adapter"]
    x = h.reshape(t // 4, 4 * dim)
    return prec.linear(F.gelu(prec.linear(x, ad["w0"])), ad["w1"])


# ---------------------------------------------------------------------------
# decoder, teacher-forced
# ---------------------------------------------------------------------------

def ada_scales(params, model: dict) -> list:
    """Per-layer ada-RMSNorm scale of the delay: ada_up(GELU(ada_down(
    [cos, sin](delay * theta^(-i/half))))), [dim] each."""
    d = model["decoder"]
    lp = params["decoder"]["layers"]
    dev = lp["ada_down"].device
    half = d["dim"] // 2
    inv = torch.exp(-math.log(d["ada_theta"])
                    * torch.arange(half, device=dev).float() / half)
    emb = float(model["delay_tokens"]) * inv
    t_cond = torch.cat([emb.cos(), emb.sin()])
    return [F.linear(F.gelu(F.linear(t_cond, lp["ada_down"][i].float())),
                     lp["ada_up"][i].float())
            for i in range(d["n_layers"])]


@torch.no_grad()
def decoder_logits(params, model: dict, rows: torch.Tensor, tokens,
                   prec: Precision):
    """The decoder over a clip's adapter rows [n, dim], fed the prompt
    (BOS on row 0, STREAMING_PAD on rows 1 .. L-1) and then the served
    `tokens` (token t on row L + t): (logits [len(tokens), vocab] float32
    at positions L-1 .. L-2+len(tokens), where the served token t was
    chosen; the hidden state [dim] after the last layer at the prompt's
    last position, L-2)."""
    d = model["decoder"]
    dp = params["decoder"]
    L = 1 + LEFT_PAD_TOKENS + model["delay_tokens"]
    n_tok = len(tokens)
    n = L - 1 + n_tok
    if n > rows.shape[0]:
        raise ValueError(f"{n_tok} tokens after a {L}-row prompt, but "
                         f"{rows.shape[0]} adapter rows")
    table = prec.dec_weight(dp["tok_embeddings"])
    ids = torch.full((n,), TOKEN_PAD, dtype=torch.long, device=rows.device)
    ids[0] = TOKEN_BOS
    ids[L:] = torch.as_tensor(list(tokens)[:-1], dtype=torch.long,
                              device=rows.device)
    h = rows[:n].float() + table[ids]
    pos = torch.arange(n, device=h.device)
    lp = dp["layers"]
    ada = ada_scales(params, model)
    nh, kh, hd = d["n_heads"], d["n_kv_heads"], d["head_dim"]
    qd, kd = nh * hd, kh * hd
    for i in range(d["n_layers"]):
        x = rms_norm(h, lp["attn_norm"][i], d["norm_eps"])
        qkv = prec.dec_linear(x, lp["wqkv"][i])
        q = rope(qkv[:, :qd].view(n, nh, hd), pos, d["rope_theta"])
        k = prec.kv(rope(qkv[:, qd:qd + kd].view(n, kh, hd), pos,
                         d["rope_theta"]))
        v = prec.kv(qkv[:, qd + kd:].view(n, kh, hd))
        a = attention(q, k, v, d["window"]).reshape(n, qd)
        h = h + prec.dec_linear(a, lp["wo"][i])
        x = rms_norm(h, lp["ffn_norm"][i], d["norm_eps"]) * (1.0 + ada[i])
        g13 = prec.dec_linear(x, lp["w13"][i])
        hid = g13.shape[1] // 2
        h = h + prec.dec_linear(F.silu(g13[:, :hid]) * g13[:, hid:],
                                lp["w2"][i])
    x = rms_norm(h[L - 1:], dp["final_norm"], d["norm_eps"])
    return prec.dec_linear(x, dp["tok_embeddings"]), h[L - 2]


def logit_gaps(logits: torch.Tensor, tokens) -> torch.Tensor:
    """Per position: how far the chosen token's logit lies below the best
    one, [len(tokens)] float32 (0 where the token is the argmax)."""
    idx = torch.as_tensor(list(tokens), dtype=torch.long,
                          device=logits.device)
    return logits.max(dim=-1).values - logits.gather(-1, idx[:, None])[:, 0]
