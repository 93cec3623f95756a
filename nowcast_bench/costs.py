"""The yardstick's arithmetic, counted from a configuration's shapes and
never from what an implementation dispatches: one call's counted work
(``CallCost``, which each system module's ``call_cost`` gives), the bytes
and the bound of GroupNorm calls, and the card's published peaks. A
GroupNorm call moves x once in, y once out, and its scale and bias once.
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


class CallCost(NamedTuple):
    """One call of the timed entry: FLOPs, GroupNorm calls as (N, C, H, W,
    silu), and the bytes of one element of those calls' x, y, scale and
    bias."""
    flops: int
    gn_calls: List[tuple]
    gn_elem_bytes: int


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
