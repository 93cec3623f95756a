"""Layout engine: permute (B, T, C, H, W)-family layout strings (a copy of
weatherforecastingtoolkit_tpu/ops/layout.py, which imports no JAX).

``change_layout`` works on numpy arrays and torch tensors alike: it is a
pure reshape/transpose (``permute`` for a tensor). Layout strings use
N(batch) T(time) C(channel=1) H W; 'C' is materialized as a size-1 axis
like the reference. ``layout_to_in_out_slice`` splits the T axis into input
and output windows.
"""

from __future__ import annotations

from typing import Sequence, Tuple

VALID_AXES = set("NTCHW")


def _expanded(layout: str) -> str:
    for ch in layout:
        if ch not in VALID_AXES:
            raise ValueError(f"Invalid layout axis {ch!r} in {layout!r}")
    if len(set(layout)) != len(layout):
        raise ValueError(f"Duplicate axes in layout {layout!r}")
    return layout


def change_layout(data, in_layout: str, out_layout: str):
    """Permute `data` from `in_layout` to `out_layout`.

    Axes present in `out_layout` but not `in_layout` are inserted as size-1
    (only 'C' may be inserted/dropped, matching the reference where C==1).
    Works on numpy arrays and torch tensors.
    """
    in_layout = _expanded(in_layout)
    out_layout = _expanded(out_layout)
    if data.ndim != len(in_layout):
        raise ValueError(f"data.ndim={data.ndim} != len(in_layout={in_layout!r})")

    # Drop axes absent from out_layout (must be size 1).
    work_layout = in_layout
    for ax in in_layout:
        if ax not in out_layout:
            if ax != "C":
                raise ValueError(f"Cannot drop non-channel axis {ax!r}")
            idx = work_layout.index(ax)
            if data.shape[idx] != 1:
                raise ValueError(f"Cannot drop axis {ax!r} of size {data.shape[idx]}")
            data = data.reshape(data.shape[:idx] + data.shape[idx + 1:])
            work_layout = work_layout.replace(ax, "")

    # Insert missing axes as size 1 at the front (then transposed into place).
    for ax in out_layout:
        if ax not in work_layout:
            if ax != "C":
                raise ValueError(f"Cannot insert non-channel axis {ax!r}")
            data = data.reshape((1,) + data.shape)
            work_layout = ax + work_layout

    perm = tuple(work_layout.index(ax) for ax in out_layout)
    if perm != tuple(range(len(perm))):
        data = (data.permute(perm) if hasattr(data, "permute")
                else data.transpose(perm))
    return data


def layout_to_in_out_slice(layout: str, in_len: int, out_len: int = None
                           ) -> Tuple[Sequence, Sequence]:
    """Build slicers that split the T axis into input/output windows.

    Mirrors reference pipeline/datasets/sevire/sevir.py:20-29: returns
    (in_slice, out_slice) lists of per-axis slice objects.
    """
    t_axis = layout.find("T")
    if t_axis < 0:
        raise ValueError(f"Layout {layout!r} has no T axis")
    num_axes = len(layout)
    in_slice = [slice(None)] * num_axes
    out_slice = [slice(None)] * num_axes
    in_slice[t_axis] = slice(None, in_len)
    if out_len is None:
        out_slice[t_axis] = slice(in_len, None)
    else:
        out_slice[t_axis] = slice(in_len, in_len + out_len)
    return in_slice, out_slice
