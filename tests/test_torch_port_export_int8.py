"""The port's dynamic ``int8`` serving pipeline through ``torch.export``
(parallel/serving.py::export_pipeline), on the CPU, without JAX.

The pipeline is ``experiments_gpu/perf/bench_helpers.py::build_pipeline``
at 32x32 with a two-level VAE at its seeded init, exported before its first
eager call (tests/torch_port_export.py). Its eager call after the export
gives the bits of a pipeline never exported (``QConv``'s weight cache held
the trace's fake tensors before: every later eager call returned a tensor
that could not be read), and the program gives the eager bits at two
batches. tests/test_torch_port_export.py holds int8_static and the mixed
spec to the JAX package.
"""

import pytest
import torch

from torch_port_export import ExportedPipeline


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield ExportedPipeline("int8", tmp_path_factory.mktemp("int8"),
                           load=False)
    torch.set_num_threads(prev)


def test_eager_call_after_export_keeps_its_bits(exported):
    """Exported before its first eager call, the pipeline's eager call gives
    a never-exported pipeline's bits."""
    assert torch.equal(exported.output("pipe", 2),
                       exported.output("fresh", 2))


def test_exported_program_gives_eager_bits(exported):
    """The eager bits at batches 2 and 3, the int8 ops once an int8 conv,
    no weight quantized in the program."""
    exported.check_program("int8")
