"""Helpers for the port's export tests (tests/test_torch_port_export*.py):
bench.py's pipelines (``experiments_gpu/perf/bench_helpers.py::
build_pipeline``) at 32x32 with a two-level VAE, exported before their
first eager call by ``parallel/serving.py::export_pipeline``."""

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from experiments_gpu.perf import bench_helpers as bh  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.parallel.serving import (  # noqa: E402
    export_pipeline, load_pipeline)

HW = 32
KW = dict(block_out_channels=(32, 64), latent_channels=4, norm_num_groups=8)
INT8_MIXED_SPEC = (("encoder/mid_block*", "int8_static"), ("*", "native"))
MODES = {"int8": "int8", "int8_static": "int8_static",
         "mixed": INT8_MIXED_SPEC}
# int8 convs of one call: every conv of the two-level VAE but quant_conv and
# post_quant_conv, or the encoder mid block's four
INT8_CONVS = {"int8": 28, "int8_static": 28, "mixed": 4}


def frames(b, seed=0):
    return bh.frames_for(b, HW, device="cpu", seed=seed)


def pipeline(mode, state=None, qscales=None):
    """(pipeline, forecaster) of ``mode`` (a key of MODES or "native") in
    fp32 on the CPU; the VAE's weights are ``state`` (else its seeded
    init)."""
    return bh.build_pipeline("float32", MODES.get(mode, mode), vae_kwargs=KW,
                             hw=HW, device="cpu", vae_state=state,
                             qscales=qscales)


class ExportedPipeline:
    """One mode's pipeline exported before its first eager call, with a
    pipeline never exported beside it. Every output is computed once and
    shared by the tests: an export and an eager call each take seconds on
    the CPU. ``call`` is the program as ``load_pipeline`` serves it, or,
    with ``load=False``, the exported module under inference mode."""

    def __init__(self, mode, tmp, state=None, qscales=None, load=True):
        self.pipe, self.fc = pipeline(mode, state, qscales)
        path = str(tmp / "rollout.pt2")
        self.program = export_pipeline(self.pipe, self.fc, frames(2), path)
        self.call = (load_pipeline(path) if load else
                     torch.inference_mode()(self.program.module()))
        self.fresh = pipeline(mode, state, qscales)[0]
        self._outputs = {}

    def output(self, which, b):
        """which: 'pipe' (the exported pipeline's eager call), 'fresh' (the
        never-exported one's) or 'call' (the program's), at batch b."""
        if (which, b) not in self._outputs:
            x = frames(b, seed=b - 2)
            self._outputs[which, b] = (
                self.call(x) if which == "call" else
                getattr(self, which)(self.fc, x))
        return self._outputs[which, b]

    def check_program(self, mode):
        """The program gives the eager bits at the export batch (2) and at
        another (3), calls the int8 ops once per int8 conv, and holds the
        weight codes as constants: no round of the weights in its graph."""
        for b in (2, 3):
            assert torch.equal(self.output("call", b),
                               self.output("fresh", b)), b
        graph = str(self.program.graph)
        n = INT8_CONVS[mode]
        assert graph.count("wftk.int8_conv2d") == n
        assert graph.count("wftk.int8_quantize") == n
        assert "aten.round" not in graph
