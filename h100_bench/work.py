"""Operations and bytes of the model's work, from shapes alone.

The functions read the configuration's widths, the traffic's sizes and
call counts, never the program, so that a change of a kernel cannot change
what its share of the roofline is measured against.  Bytes count each
input read once and each output written once; K/V count at each step's
own fill.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense (the port's
`chip_smoke.py` `HBM_BYTES_PER_S` and `BF16_FLOPS`).  The int8 product
widens its weights onto the bf16 tensor cores, so its operations count
against the bf16 peak.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

BYTES = {"bf16": 2, "int8": 1, "e4m3": 1}


def roofline_s(n_bytes: float, n_flops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the bf16 tensor-core rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOPS)


# ---------------------------------------------------------------------------
# the decoder's products (105 a decode step, 104 a prefill)
# ---------------------------------------------------------------------------

def decoder_products(model: dict) -> list[tuple[int, int, int]]:
    """(out, in, count a pass) of the decoder's products: each layer's
    wqkv, wo, w13, w2."""
    d = model["decoder"]
    q = d["n_heads"] * d["head_dim"]
    kv = d["n_kv_heads"] * d["head_dim"]
    n = d["n_layers"]
    return [(q + 2 * kv, d["dim"], n), (d["dim"], q, n),
            (2 * d["hidden"], d["dim"], n), (d["dim"], d["hidden"], n)]


def logits_product(model: dict) -> tuple[int, int, int]:
    d = model["decoder"]
    return (d["vocab_size"], d["dim"], 1)


def product_work(products, rows: int, weight: str) -> tuple[float, float]:
    """(bytes, flops) of `products` at `rows` rows: the weight (int8: a byte
    and one float32 scale a row of it), the bf16 input, the float32 output."""
    wb = BYTES[weight]
    n_bytes = n_flops = 0.0
    for out, inp, count in products:
        per = out * inp * wb + rows * inp * 2 + rows * out * 4
        if weight == "int8":
            per += out * 4
        n_bytes += count * per
        n_flops += count * 2.0 * rows * inp * out
    return n_bytes, n_flops


def decoder_mm_work(model: dict, batch: int, steps: int, prompt: int,
                    weight: str) -> tuple[float, float]:
    """A batch's decoder products: one prefill of `prompt` - 1 rows a
    stream (the layers' 104), then `steps` decode steps (the layers' 104
    and the logits)."""
    layers = decoder_products(model)
    b1, f1 = product_work(layers, batch * (prompt - 1), weight)
    b2, f2 = product_work(layers + [logits_product(model)], batch, weight)
    return b1 + steps * b2, f1 + steps * f2


# ---------------------------------------------------------------------------
# flash-decode: one launch a layer a step
# ---------------------------------------------------------------------------

def flash_decode_work(model: dict, batch: int, positions,
                      kv: str) -> tuple[float, float]:
    """Decode steps at `positions` (each step's position, every stream at
    it): per layer and stream the query read and the output written (bf16),
    the new K/V row read (float32) and written to the ring, and the ring's
    older rows of the window read, min(p, window - 1); attention over
    min(p + 1, window) keys."""
    d = model["decoder"]
    h, kh, hd, w = d["n_heads"], d["n_kv_heads"], d["head_dim"], d["window"]
    eb = BYTES[kv]
    n_bytes = n_flops = 0.0
    for p in positions:
        n_bytes += 2 * kh * hd * (eb * min(p, w - 1) + 4 + eb) \
            + 2 * h * hd * 2
        n_flops += 2 * 2 * h * hd * min(p + 1, w)
    scale = d["n_layers"] * batch
    return n_bytes * scale, n_flops * scale


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def encoder_flops(model: dict, mel_frames: int, pos0: int = 0) -> float:
    """Conv stem, the encoder's layers (position i attends min(i + 1,
    window) keys) and the adapter over `mel_frames` mel frames of one
    stream whose first encoder position is `pos0` (0 for a whole clip)."""
    e = model["encoder"]
    dim, k = e["dim"], e["conv_kernel"]
    s = mel_frames // 2
    qkv = e["n_heads"] * e["head_dim"]
    f = 2.0 * mel_frames * k * e["n_mel"] * dim + 2.0 * s * k * dim * dim
    w = e["window"]
    keys = sum(min(i + 1, w) for i in range(pos0, pos0 + s))
    per_layer = 2.0 * s * dim * (3 * qkv + qkv + 3 * e["hidden"]) \
        + 2 * 2.0 * e["n_heads"] * e["head_dim"] * keys
    f += e["n_layers"] * per_layer
    g = s // model["downsample"]
    ah = model["adapter_hidden"]
    f += 2.0 * g * (model["downsample"] * dim * ah
                    + ah * model["decoder"]["dim"])
    return f


def flash_encode_work(model: dict, t: int, positions,
                      ring: str) -> tuple[float, float]:
    """One streaming encoder chunk of `t` positions a stream, the streams at
    encoder `positions`, every layer: the queries read and the output
    written (bf16), and the ring's keys and values that the chunk's
    queries see, positions max(0, p - window + 1) .. p + t - 1."""
    e = model["encoder"]
    h, hd, w = e["n_heads"], e["head_dim"], e["window"]
    eb = BYTES[ring]
    n_bytes = n_flops = 0.0
    for p in positions:
        n_bytes += 2 * h * hd * eb * min(p + t, t + w - 1) \
            + 2 * t * h * hd * 2
        n_flops += 2 * 2 * h * hd * sum(min(p + j + 1, w) for j in range(t))
    return n_bytes * e["n_layers"], n_flops * e["n_layers"]


def decoder_flops(model: dict, positions, logits: bool) -> float:
    """The decoder at `positions` of one stream (causal attention over
    p + 1 keys up to the window), with or without the logits."""
    d = model["decoder"]
    prods = sum(out * inp * c for out, inp, c in decoder_products(model))
    if logits:
        prods += d["vocab_size"] * d["dim"]
    f = 0.0
    for p in positions:
        f += 2.0 * prods + 2 * 2.0 * d["n_layers"] * d["n_heads"] \
            * d["head_dim"] * min(p + 1, d["window"])
    return f


def offline_clip_flops(model: dict, mel_frames: int, prompt: int) -> float:
    """One clip through the offline pipeline: bulk encode, the prompt's
    prefill (positions 0 .. prompt - 2, no logits) and a decode step with
    logits at every later adapter row."""
    rows = mel_frames // 8
    return (encoder_flops(model, mel_frames)
            + decoder_flops(model, range(prompt - 1), logits=False)
            + decoder_flops(model, range(prompt - 1, rows), logits=True))
