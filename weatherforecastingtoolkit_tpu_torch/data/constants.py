"""SEVIR dataset constants (a copy of
weatherforecastingtoolkit_tpu/data/constants.py).

Parity with reference pipeline/datasets/sevir/sevir.py:36-70 (data-type
registry, raw storage dtypes, rescale tables, lightning frame times, SEVIR vs
SEVIR-LR geometry).
"""

from __future__ import annotations

import numpy as np

SEVIR_DATA_TYPES = ("vis", "ir069", "ir107", "vil", "lght")

SEVIR_RAW_DTYPES = {
    "vis": np.int16,
    "ir069": np.int16,
    "ir107": np.int16,
    "vil": np.uint8,
    "lght": np.int16,
}

# lightning point observations are binned into 5-minute frames spanning ±2 h
LIGHTNING_FRAME_TIMES = np.arange(-120.0, 125.0, 5) * 60  # seconds

SEVIR_DATA_SHAPE = {"lght": (48, 48)}

# 'sevir' rescale: physical normalization from the SEVIR paper
PREPROCESS_SCALE_SEVIR = {
    "vis": 1,
    "ir069": 1 / 1174.68,
    "ir107": 1 / 2562.43,
    "vil": 1 / 47.54,
    "lght": 1 / 0.60517,
}
PREPROCESS_OFFSET_SEVIR = {
    "vis": 0,
    "ir069": 3683.58,
    "ir107": 1552.80,
    "vil": -33.44,
    "lght": -0.02990,
}

# '01' rescale: [0, 1] range (vil only, like the reference)
PREPROCESS_SCALE_01 = {"vis": 1, "ir069": 1, "ir107": 1, "vil": 1 / 255, "lght": 1}
PREPROCESS_OFFSET_01 = {"vis": 0, "ir069": 0, "ir107": 0, "vil": 0, "lght": 0}

# dataset geometry presets (reference sevir/sevir.py:1111-1130)
DATASET_PRESETS = {
    "sevir": dict(raw_seq_len=49, interval_real_time=5, img_height=384, img_width=384),
    "sevirlr": dict(raw_seq_len=25, interval_real_time=10, img_height=128, img_width=128),
}
# the reference accepts 'sevir_lr' in places as an alias
DATASET_PRESETS["sevir_lr"] = DATASET_PRESETS["sevirlr"]

VALID_LAYOUTS = ("NHWT", "NTHW", "NTCHW", "NTHWC", "TNHW", "TNCHW", "NWHT", "NTWHC")
