"""The GroupNorm+SiLU kernel's plan (``ops/cuda/groupnorm.py::_plan``) at
every GroupNorm call shape of the serving paths, on the CPU.

The call shapes come from the port's own VAEs, run on the ``meta`` device
with the GroupNorm recorded instead of computed: the reference-shape VAE at
the batch call (B=64: 832 frames encoded, 768 latents decoded), the
streaming tick (1 and 12) and its init (13), and the fast VAE at B=256 (3328
and 3072). Each plan is checked against an H100's limits: 232,448 bytes of
shared memory a block, clusters of 8 (portable) or 16. No call shape of
these paths may take the two-pass path.

The full-resolution VAE of experiments/vae_sevir384 (AutoencoderKL(64, 128,
256, 512) at 384², 25 frames a step) is the first caller of the two-pass
path: its C=64 and C=128 GroupNorms at 384² hold more than a cluster's
shared memory, every smaller frame fits a cluster.
"""

import collections

import pytest
import torch

from chip_smoke import FAST_VAE, LATENT_SHAPE, REFERENCE_VAE
from weatherforecastingtoolkit_tpu_torch.models.vae import blocks
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL)
from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm as pgn

H100_SMEM_PER_BLOCK = 232448
# path -> (VAE, frames encoded, latents decoded, GroupNorm calls)
PATHS = {"reference B=64": (REFERENCE_VAE, 832, 768, 42),
         "streaming tick": (REFERENCE_VAE, 1, 12, 42),
         "streaming init": (REFERENCE_VAE, 13, 0, 16),
         "fast VAE B=256": (FAST_VAE, 3328, 3072, 30)}


def _call_shapes(path):
    """Counter of ((N, C, H, W), groups) over one call of `path`."""
    cfg, n_enc, n_dec, _ = PATHS[path]
    return _record(cfg, n_enc, n_dec, 128, LATENT_SHAPE)


def _record(cfg, n_enc, n_dec, hw, latent_shape):
    """Counter of ((N, C, H, W), groups) over an encode of n_enc frames of
    hw² and a decode of n_dec latents of latent_shape."""
    calls = collections.Counter()

    def record(x, scale, bias, groups=32, eps=1e-6, silu=True):
        calls[(tuple(x.shape), groups)] += 1
        return x

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocks, "group_norm_silu", record)
        mp.setattr(AutoencoderKL, "_init_weights", lambda self, rng: None)
        vae = AutoencoderKL(**cfg, device="meta")
        with torch.no_grad():
            if n_enc:
                vae.encode(torch.zeros(n_enc, 1, hw, hw, device="meta"))
            if n_dec:
                vae.decode(torch.zeros((n_dec,) + tuple(latent_shape),
                                       device="meta"))
    return calls


@pytest.fixture(scope="module")
def call_shapes():
    return {path: _call_shapes(path) for path in PATHS}


@pytest.mark.parametrize("path", list(PATHS))
def test_call_shapes_are_the_serving_paths(call_shapes, path):
    """42 GroupNorms a reference-shape call and a streaming tick, 16 in the
    init's encode, 30 a fast-VAE call (chip_smoke.py counts the same on the
    card, where every one of them is channels_last)."""
    assert sum(call_shapes[path].values()) == PATHS[path][3]


@pytest.mark.parametrize("max_cluster", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", list(PATHS))
def test_every_call_shape_takes_the_cluster_kernel(call_shapes, path, dtype,
                                                   max_cluster):
    elem = torch.empty((), dtype=dtype).element_size()
    for ((n, c, h, w), groups), _ in call_shapes[path].items():
        hw = h * w
        k, cs, ppb, vec = pgn._plan(n, c, hw, groups, elem,
                                    H100_SMEM_PER_BLOCK, max_cluster)
        where = f"{path} N={n} C={c} {h}x{w} {dtype}: plan {(k, cs, ppb, vec)}"
        assert cs > 0, f"two-pass path at {where}"
        assert vec * elem == 16, where
        assert groups % k == 0 and k <= pgn.MAX_SLAB_GROUPS, where
        run = k * (c // groups) * elem                 # bytes a position
        assert run >= 32 and run % 16 == 0 and run <= 256, where
        assert (run // 16) & (run // 16 - 1) == 0, where   # threads a position
        assert cs & (cs - 1) == 0 and cs <= max_cluster, where
        assert ppb * cs >= hw and ppb * (cs - 1) < hw, where
        assert ppb * run <= H100_SMEM_PER_BLOCK - pgn.STATIC_SMEM, where
        assert hw * run <= cs * H100_SMEM_PER_BLOCK, where


def test_large_frames_take_wide_runs_on_clusters_of_16(call_shapes):
    """128x128 frames: 64-byte runs on clusters of 16 where the card
    schedules them, 32-byte runs on clusters of 8 where it does not; each
    block holds 64 KB of its slab."""
    for (n, c, h, w), groups in call_shapes["reference B=64"]:
        if (h, w) != (128, 128):
            continue
        for max_cluster, run, cs in ((16, 64, 16), (8, 32, 8)):
            k, got_cs, ppb, _ = pgn._plan(n, c, h * w, groups, 2,
                                          H100_SMEM_PER_BLOCK, max_cluster)
            assert (k * (c // groups) * 2, got_cs) == (run, cs)
            assert ppb * run == 64 * 1024


@pytest.mark.parametrize("n,c,hw,groups,elem,want", [
    (2, 18, 35, 6, 4, (0, 0, 0, 1)),          # C not a multiple of the vector
    (2, 40, 81, 8, 2, (0, 0, 0, 8)),          # 10-byte groups: no run fits
    (1, 64, 4096 * 4096, 32, 2, (0, 0, 0, 8)),  # slab over 16 blocks
])
def test_two_pass_shapes(n, c, hw, groups, elem, want):
    assert pgn._plan(n, c, hw, groups, elem, H100_SMEM_PER_BLOCK, 16) == want


# experiments/vae_sevir384/config.yaml's model; a step encodes B*T = 25
# frames of 384² and decodes their 4x48x48 latents
SEVIR384_VAE = dict(in_channels=1, out_channels=1,
                    block_out_channels=(64, 128, 256, 512),
                    layers_per_block=1, latent_channels=4, norm_num_groups=32)


@pytest.mark.parametrize("max_cluster", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vae_sevir384_two_pass_shapes(dtype, max_cluster):
    """Of the 36 GroupNorms of a vae_sevir384 forward (14 in the encode, 22
    in the decode), the seven at 384² take the two-pass path: C=64 twice in
    the encoder's first block, C=128 (the first resnet's norm1) and C=64
    three times in the decoder's last up block, and conv_norm_out (C=64).
    Every call shape from 192² down takes the cluster kernel."""
    calls = _record(SEVIR384_VAE, 25, 25, 384, (4, 48, 48))
    assert sum(calls.values()) == 36
    elem = torch.empty((), dtype=dtype).element_size()
    two_pass = collections.Counter()
    for ((n, c, h, w), groups), count in calls.items():
        plan = pgn._plan(n, c, h * w, groups, elem, H100_SMEM_PER_BLOCK,
                         max_cluster)
        if plan[1] == 0:
            two_pass[(n, c, h, w)] += count
            assert plan == (0, 0, 0, 16 // elem)
    assert two_pass == {(25, 64, 384, 384): 6, (25, 128, 384, 384): 1}
