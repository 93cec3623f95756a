"""Multi-process data parallelism of the port for real (counterpart of
tests/test_multihost.py): two OS processes in one gloo group, each fed its
OWN event shard by SEVIRDataModule's torch.distributed auto-sharding, take
one DP step and one FSDP step (tests/torch_port_dist_worker.py, case
"multihost"); the result must equal one process's step on the
concatenated data. The FSDP parameters are split between the processes,
written as a sharded checkpoint by both and read back into shards."""

import os

import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu_torch.data.datamodule import SEVIRDataModule
from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
    make_synthetic_sevir)

from torch_port_dist_worker import TinyNet, run_group, tiny_step


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("multihost"))
    # 8 events x 1 window (stride 25 = raw_seq_len): 4 per shard
    make_synthetic_sevir(os.path.join(root, "sevir"), num_events=8,
                         height=32, width=32, raw_seq_len=25)
    results, logs = run_group("multihost", root)
    for log in logs:
        assert "auto-sharding events" in log
    dm = SEVIRDataModule(dataset_name="sevirlr",
                         sevir_dir=os.path.join(root, "sevir"), seq_len=4,
                         stride=25, layout="NTCHW", batch_size=8,
                         num_workers=0, shuffle_train=False, val_ratio=0.0,
                         train_test_split_date=None)
    dm.prepare_data()
    dm.setup(stage="fit")
    full = torch.as_tensor(np.asarray(next(iter(dm.train_loader()))["vil"],
                                      np.float32))
    assert full.shape[0] == 8
    one = TinyNet()
    loss = tiny_step(one, full)
    return results, (loss, {k: p.detach().numpy()
                            for k, p in one.named_parameters()})


def test_two_process_dp_step_matches_single_process(two_processes):
    results, (loss, ref) = two_processes
    a, b = results[0], results[1]
    assert a["shards"] == (2, 0) and b["shards"] == (2, 1)
    assert a["rows"] == b["rows"] == 4
    for k, v in ref.items():
        np.testing.assert_array_equal(a["dp"][k], b["dp"][k])
        np.testing.assert_allclose(a["dp"][k], v, rtol=2e-5, atol=2e-6,
                                   err_msg=k)
    assert a["dp_loss"] == pytest.approx(loss, rel=2e-5)


def test_two_process_fsdp_step_matches_single_process(two_processes):
    """Neither process holds a split leaf whole; reassembled, the two
    shards give the one-process step. The sharded checkpoint reads back
    into a fresh sharded module with the same values."""
    results, (loss, ref) = two_processes
    a, b = results[0], results[1]
    split = 0
    for k, want in ref.items():
        (pa, dim), (pb, dim_b) = a["fsdp"][k], b["fsdp"][k]
        assert dim == dim_b
        if dim < 0:
            np.testing.assert_array_equal(pa, pb)
            got = pa
        else:
            assert pa.shape[dim] == want.shape[dim] // 2
            got = np.concatenate([pa, pb], axis=dim)
            split += 1
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6,
                                   err_msg=k)
    assert split >= 2   # both conv kernels really were split
    assert a["fsdp_loss"] == pytest.approx(loss, rel=2e-5)
    assert a["ckpt_equal"] and b["ckpt_equal"]
