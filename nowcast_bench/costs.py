"""The yardstick's arithmetic, counted from a configuration's shapes and
never from what an implementation dispatches: the FLOPs of a Path-B call
(convolutions, attention's matrix products, DLinear), the GroupNorm calls
and the bytes their bound counts, and the card's published peaks.

A 3x3 conv over an Ho x Wo output counts 2 * Ho * Wo * Cin * Cout * 9;
attention over P positions of C channels counts four C x C linear maps
(2 * P * C * C each) and the two P x P products (2 * P * P * C each);
DLinear counts two (T_out x T_in) maps over every latent element. GroupNorm,
SiLU, the upsample, the adds and the casts count no FLOPs. A GroupNorm call
moves x once in, y once out, and its scale and bias once.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

# {device-name prefix: peaks} from NVIDIA's H100 SXM data sheet (dense, no
# sparsity), at the card's full 700 W power limit
DEVICE_PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "bytes": 3.35e12,
                              "int8_ops": 1978.9e12, "fp32_flops": 67e12},
}
GN_OPS_PER_ELEMENT = {True: 10, False: 7}   # with and without SiLU
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


class Frame(NamedTuple):
    """Per-frame work of one VAE half: FLOPs, and each GroupNorm call as
    (C, H, W, silu)."""
    flops: int
    gn: List[tuple]


def _walk(vae: dict, hw: int, half: str) -> Frame:
    boc = list(vae["block_out_channels"])
    n, lpb, lat = len(boc), vae["layers_per_block"], vae["latent_channels"]
    f = vae.get("pixel_unshuffle", 1)
    flops, gn = 0, []

    def conv(h, cin, cout, k):
        nonlocal flops
        flops += 2 * h * h * cin * cout * k * k

    def resnet(h, cin, cout):
        gn.append((cin, h, h, True))
        conv(h, cin, cout, 3)
        gn.append((cout, h, h, True))
        conv(h, cout, cout, 3)
        if cin != cout:
            conv(h, cin, cout, 1)

    def mid(h, c):
        nonlocal flops
        resnet(h, c, c)
        gn.append((c, h, h, False))
        p = h * h
        flops += 4 * 2 * p * c * c + 2 * 2 * p * p * c
        resnet(h, c, c)

    if half == "encode":
        h = hw // f
        conv(h, vae["in_channels"] * f * f, boc[0], 3)
        for i, ch in enumerate(boc):
            for j in range(lpb):
                resnet(h, boc[max(i - 1, 0)] if j == 0 else ch, ch)
            if i != n - 1:
                h //= 2
                conv(h, ch, ch, 3)
        mid(h, boc[-1])
        gn.append((boc[-1], h, h, True))
        conv(h, boc[-1], 2 * lat, 3)
        conv(h, 2 * lat, 2 * lat, 1)
    else:
        rev = boc[::-1]
        h = hw // (f * 2 ** (n - 1))
        conv(h, lat, lat, 1)
        conv(h, lat, rev[0], 3)
        mid(h, rev[0])
        for i, ch in enumerate(rev):
            for j in range(lpb + 1):
                resnet(h, rev[max(i - 1, 0)] if j == 0 else ch, ch)
            if i != n - 1:
                h *= 2
                conv(h, ch, ch, 3)
        gn.append((rev[-1], h, h, True))
        conv(h, rev[-1], vae["out_channels"] * f * f, 3)
    return Frame(flops, gn)


class CallCost(NamedTuple):
    """One call of the timed entry: FLOPs, GroupNorm calls as (N, C, H, W,
    silu), and the frames it encodes and decodes."""
    flops: int
    gn_calls: List[tuple]
    frames_encoded: int
    frames_decoded: int


def call_cost(cfg: dict, batch: int, frames_encoded_per_seq: int) -> CallCost:
    """The cost of one call over ``batch`` sequences that encodes
    ``frames_encoded_per_seq`` frames a sequence (T_in for a batch call, 1
    for a streaming tick) and decodes T_out."""
    vae, hw = cfg["vae"], cfg["frame_hw"]
    enc, dec = _walk(vae, hw, "encode"), _walk(vae, hw, "decode")
    n_enc = batch * frames_encoded_per_seq
    n_dec = batch * cfg["pred_frames"]
    fc = cfg["forecaster"]
    lhw = hw // (vae.get("pixel_unshuffle", 1) * 2 ** (len(vae["block_out_channels"]) - 1))
    d = vae["latent_channels"] * lhw * lhw
    dl = 2 * 2 * batch * d * fc["seq_len"] * fc["pred_len"]
    gn = ([(n_enc,) + g for g in enc.gn] + [(n_dec,) + g for g in dec.gn])
    return CallCost(n_enc * enc.flops + n_dec * dec.flops + dl, gn, n_enc, n_dec)


def gn_bytes(n: int, c: int, h: int, w: int, elem_bytes: int,
             param_bytes: int) -> int:
    """Bytes one GroupNorm call must move: x read once, y written once,
    scale and bias read once."""
    return 2 * n * c * h * w * elem_bytes + 2 * c * param_bytes


def gn_bound_s(gn_calls: List[tuple], elem_bytes: int, param_bytes: int,
               peaks: Dict[str, float]) -> float:
    """The least seconds the card could take for these GroupNorm calls: per
    call the larger of its bytes over the memory's rate and its fp32
    operations over the fp32 rate."""
    total = 0.0
    for n, c, h, w, silu in gn_calls:
        by = gn_bytes(n, c, h, w, elem_bytes, param_bytes) / peaks["bytes"]
        ops = GN_OPS_PER_ELEMENT[silu] * n * c * h * w / peaks["fp32_flops"]
        total += max(by, ops)
    return total


def device_peaks(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``kind`` (the longest matching prefix),
    or None for a card without a row."""
    rows = [k for k in DEVICE_PEAKS if kind.startswith(k)]
    return DEVICE_PEAKS[max(rows, key=len)] if rows else None
