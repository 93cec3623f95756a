"""The port's SEVIR data layer against the JAX package's (CPU): the same
synthetic trees give bit-equal batches through both SEVIRDataModules (HDF5
and packed cache, augmentation, layouts, rescales, shards, the 3-way date
split), each package reads the other's trees and caches, the catalog,
preflight, download, the cache-build race, the host-side helpers, and what
the data layer may import (no pandas; h5py only where HDF5 is read or
written)."""

import ast
import datetime
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import test_download  # the mock public-S3 server (same dir, pytest sys.path)
from weatherforecastingtoolkit_tpu.data import cache as jcache
from weatherforecastingtoolkit_tpu.data import catalog as jcatalog
from weatherforecastingtoolkit_tpu.data import datamodule as jdm
from weatherforecastingtoolkit_tpu.data import dataset as jdataset
from weatherforecastingtoolkit_tpu.data import downsample_writer as jdown
from weatherforecastingtoolkit_tpu.data import hdf5 as jhdf5
from weatherforecastingtoolkit_tpu.data import preflight as jpre
from weatherforecastingtoolkit_tpu.data import synthetic as jsyn
from weatherforecastingtoolkit_tpu.data import windows as jwin
from weatherforecastingtoolkit_tpu_torch.data import benchmark as pbench
from weatherforecastingtoolkit_tpu_torch.data import cache as pcache
from weatherforecastingtoolkit_tpu_torch.data import catalog as pcatalog
from weatherforecastingtoolkit_tpu_torch.data import datamodule as pdm
from weatherforecastingtoolkit_tpu_torch.data import dataset as pdataset
from weatherforecastingtoolkit_tpu_torch.data import download as pdl
from weatherforecastingtoolkit_tpu_torch.data import downsample_writer as pdown
from weatherforecastingtoolkit_tpu_torch.data import hdf5 as phdf5
from weatherforecastingtoolkit_tpu_torch.data import preflight as ppre
from weatherforecastingtoolkit_tpu_torch.data import synthetic as psyn
from weatherforecastingtoolkit_tpu_torch.data import windows as pwin
from weatherforecastingtoolkit_tpu_torch.training import profiling as pprof

REPO = Path(__file__).resolve().parents[1]
server = test_download.server  # fixture

# 10 events a week apart from 2019-04-15: 7 before the 2019-06-01 split
# date, 3 after; vil + lght over 4 HDF5 files a type
TREE = dict(num_events=10, height=32, width=32, raw_seq_len=25,
            data_types=("vil", "lght"), events_per_file=3,
            start_date="2019-04-15")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sevir_vil_lght"))
    jsyn.make_synthetic_sevir(root, **TREE)
    return root


def _same(a, b, where):
    assert a.keys() == b.keys(), where
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
        assert np.array_equal(x, y, equal_nan=x.dtype.kind in "fc"), \
            (where, k)


def _same_batches(jloader, ploader, where):
    assert len(jloader) == len(ploader), where
    n = 0
    for jb, pb in zip(jloader, ploader):
        _same(jb, pb, f"{where} batch {n}")
        n += 1
    assert n == len(jloader), where


# (label, SEVIRDataModule kwargs); "ceil" builds the datasets directly
# (the data module always shards 'uneven')
CASES = [
    ("hdf5", dict()),
    ("cache", dict(use_cache=True)),
    ("hdf5-aug1", dict(aug_mode="1")),
    ("cache-aug1", dict(use_cache=True, aug_mode="1")),
    ("hdf5-aug2-NTHWC", dict(aug_mode="2", layout="NTHWC")),
    ("cache-aug2-NHWT", dict(use_cache=True, aug_mode="2", layout="NHWT")),
    ("hdf5-sevir", dict(rescale_method="sevir")),
    ("cache-01_uint8-NTHWC", dict(use_cache=True, rescale_method="01_uint8",
                                  layout="NTHWC")),
    ("hdf5-shard2-rank0", dict(num_shard=2, rank=0)),
    ("cache-shard2-rank1", dict(use_cache=True, num_shard=2, rank=1)),
    ("hdf5-val_split_date", dict(val_split_date=(2019, 5, 10))),
    ("cache-val_split_date-aug2", dict(use_cache=True, aug_mode="2",
                                       val_split_date=(2019, 5, 10))),
    ("hdf5-ceil", dict(split_mode="ceil")),
    ("cache-ceil", dict(use_cache=True, split_mode="ceil")),
    ("hdf5-autoshard", dict(auto_shard=True)),
]


@pytest.mark.parametrize("label,kw", CASES, ids=[c[0] for c in CASES])
def test_batches_bit_equal(tree, tmp_path, monkeypatch, label, kw):
    """Both packages' data modules give the same batches (same dtype,
    shape and bits) for train, val and test."""
    kw = dict(kw)
    if kw.pop("split_mode", None) == "ceil":
        _ceil_datasets_equal(tree, tmp_path, kw.get("use_cache", False))
        return
    common = dict(dataset_name="sevirlr", sevir_dir=tree, seq_len=8,
                  stride=6, batch_size=2, num_workers=1, seed=3,
                  data_types=("vil", "lght"), val_ratio=0.25)
    common.update(kw)
    jkw, pkw = dict(common), dict(common)
    if kw.get("use_cache"):
        jkw["cache_dir"] = str(tmp_path / "jax_cache")
        pkw["cache_dir"] = str(tmp_path / "port_cache")
    if jkw.pop("auto_shard", None):
        pkw.pop("auto_shard")
        # rank 1 of 2 under torch.distributed shards like an explicit 2/1
        import torch.distributed as dist
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda: 2)
        monkeypatch.setattr(dist, "get_rank", lambda: 1)
        jkw.update(num_shard=2, rank=1)
    jm, pm = jdm.SEVIRDataModule(**jkw), pdm.SEVIRDataModule(**pkw)
    assert (pm.num_shard, pm.rank) == (jm.num_shard, jm.rank)
    for m in (jm, pm):
        m.prepare_data()
        m.setup()
    assert len(pm.sevir_train) > 0 and len(pm.sevir_val) > 0
    assert len(pm.sevir_test) > 0
    for split in ("train", "val", "test"):
        _same_batches(getattr(jm, f"{split}_loader")(),
                      getattr(pm, f"{split}_loader")(), f"{label} {split}")
    jm.sevir_train.set_epoch(1)
    pm.sevir_train.set_epoch(1)
    _same(jm.sevir_train[0], pm.sevir_train[0], f"{label} epoch 1")
    if kw.get("use_cache"):
        # the packed files are the same bytes
        for name in sorted(os.listdir(jkw["cache_dir"])):
            if name.endswith(".npy"):
                assert (Path(jkw["cache_dir"], name).read_bytes()
                        == Path(pkw["cache_dir"], name).read_bytes()), name


def _ceil_datasets_equal(tree, tmp_path, use_cache):
    """split_mode='ceil' over 3 shards of 7 events: the last shard is
    padded by wrapping, in both packages, on both paths."""
    cat = os.path.join(tree, "CATALOG.csv")
    data = os.path.join(tree, "data")
    for rank in range(3):
        kw = dict(data_types=("vil", "lght"), seq_len=8, raw_seq_len=25,
                  stride=6, layout="NTCHW", num_shard=3, rank=rank,
                  split_mode="ceil", end_date=datetime.datetime(2019, 6, 1))
        if use_cache:
            full = dict(kw, num_shard=1, rank=0, split_mode="uneven",
                        seq_len=25, stride=25)
            jcache.build_cache(jdataset.SEVIRDataset(cat, data, **full),
                               str(tmp_path / "j"), verbose=False)
            pcache.build_cache(pdataset.SEVIRDataset(cat, data, **full),
                               str(tmp_path / "p"), verbose=False)
            ckw = dict(data_types=("vil", "lght"), seq_len=8, stride=6,
                       layout="NTCHW", num_shard=3, rank=rank,
                       split_mode="ceil")
            jd = jcache.CachedSEVIRDataset(str(tmp_path / "j"), **ckw)
            pd_ = pcache.CachedSEVIRDataset(str(tmp_path / "p"), **ckw)
        else:
            jd = jdataset.SEVIRDataset(cat, data, **kw)
            pd_ = pdataset.SEVIRDataset(cat, data, **kw)
        assert len(jd) == len(pd_) > 0
        for i in range(len(jd)):
            _same(jd[i], pd_[i], f"ceil rank {rank} sample {i}")


def test_trees_cross_read(tmp_path):
    """make_synthetic_sevir writes the same bytes in both packages, and each
    package's data module reads the other's tree and packed cache."""
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(TREE, data_types=("vil", "lght", "ir069"))
    assert (jsyn.make_synthetic_sevir(jroot, **kw).endswith("CATALOG.csv")
            and psyn.make_synthetic_sevir(proot, **kw).endswith("CATALOG.csv"))
    files = sorted(p.relative_to(jroot) for p in Path(jroot).rglob("*")
                   if p.is_file())
    assert len(files) == 13
    assert files == sorted(p.relative_to(proot) for p in Path(proot).rglob("*")
                           if p.is_file())
    for rel in files:
        assert Path(jroot, rel).read_bytes() == Path(proot, rel).read_bytes()

    dm_kw = dict(dataset_name="sevirlr", seq_len=8, stride=6, batch_size=2,
                 num_workers=1, data_types=("vil", "ir069"))
    jm = jdm.SEVIRDataModule(sevir_dir=proot, use_cache=True, **dm_kw)
    pm = pdm.SEVIRDataModule(sevir_dir=jroot, **dm_kw)
    for m in (jm, pm):
        m.prepare_data()
        m.setup()
    for split in ("train", "val", "test"):
        _same_batches(getattr(jm, f"{split}_loader")(),
                      getattr(pm, f"{split}_loader")(), f"cross {split}")
    # the port serves the cache the JAX package built in the port's tree
    pm_cache = pdm.SEVIRDataModule(sevir_dir=proot, use_cache=True, **dm_kw)
    pm_cache._build_cache_once = None   # a rebuild would fail here
    pm_cache.prepare_data()
    pm_cache.setup()
    _same_batches(jm.test_loader(), pm_cache.test_loader(), "cross cache")


def _catalog_rows():
    """A catalog with the real header's extra mixed-type columns, a
    duplicated event, an event missing a type, pct_missing > 0, NaN
    pct_missing, an empty lght file_index and times around a window."""
    rows = []
    t0 = datetime.datetime(2018, 5, 1, 10, 40)
    for n in range(12):
        eid = f"R18{n:05d}"
        for t in ("vil", "ir069", "lght"):
            if n == 3 and t == "ir069":
                continue                       # missing a type
            rows.append(dict(
                id=eid, file_name=f"{t}/2018/SEVIR_{t.upper()}_{n % 2}.h5",
                file_index="" if t == "lght" else str(n // 2),
                img_type=t, time_utc=(t0 + datetime.timedelta(
                    hours=7 * n)).strftime("%Y-%m-%d %H:%M:%S"),
                minute_offsets=":".join(str(5 * i) for i in range(3)),
                event_type=("Hail" if n % 3 else 42),
                pct_missing=("0.5" if (n == 5 and t == "vil") else
                             "" if n == 7 else "0"),
                size_x=384 if n % 2 else "384.0"))
        if n == 9:
            rows.append(dict(rows[-1]))        # duplicated row
    return rows


def test_catalog_event_index(tmp_path):
    path = str(tmp_path / "CATALOG.csv")
    rows = _catalog_rows()
    pd.DataFrame(rows).to_csv(path, index=False)
    df = pd.read_csv(path, parse_dates=["time_utc"], low_memory=False)
    cols = pcatalog.load_catalog(path)
    assert list(cols) == list(df.columns)
    assert list(cols["id"]) == list(df.id)
    assert np.array_equal(cols["pct_missing"], df.pct_missing.to_numpy(),
                          equal_nan=True)
    assert np.array_equal(cols["file_index"], df.file_index.to_numpy(),
                          equal_nan=True)
    assert np.array_equal(cols["time_utc"],
                          df.time_utc.to_numpy().astype("datetime64[us]"))
    start, end = datetime.datetime(2018, 5, 1, 17), datetime.datetime(2018, 5, 4)
    cases = [
        (("vil",), None, None, None, None),
        (("vil", "ir069"), None, None, None, None),
        (("vil", "ir069", "lght"), None, None, None, None),
        (("vil", "lght"), start, end, None, None),
        (("ir069",), None, None, None, "none"),
        (("vil",), None, None, "hour", "default"),
        (("vil", "lght"), None, None, None, "size"),
    ]
    for types, s, e, dtf, cf in cases:
        jf = pf = None
        if dtf == "hour":
            jf = lambda t: t.dt.hour >= 12  # noqa: E731
            pf = lambda t: (t.astype("datetime64[h]").astype(int) % 24) >= 12  # noqa: E731
        jc = pc = "default" if cf in (None, "default") else None
        if cf == "size":
            jc = lambda c: c.size_x.astype(float) == 384  # noqa: E731
            pc = lambda c: c["size_x"].astype(float) == 384  # noqa: E731
        jidx = jcatalog.build_event_index(path, types, s, e, jf, jc)
        pidx = pcatalog.build_event_index(path, types, s, e, pf, pc)
        assert len(pidx) > 0, types
        assert [vars(ev) for ev in jidx] == [vars(ev) for ev in pidx], types
        assert jidx.filenames == pidx.filenames
        assert ([ev.event_id for ev in jidx.shuffled(5)]
                == [ev.event_id for ev in pidx.shuffled(5)])
    # the writer gives pandas' bytes for the writers' row types
    written = [dict(id=r["id"], file_name=r["file_name"], file_index=3,
                    img_type=r["img_type"],
                    time_utc=datetime.datetime.fromisoformat(r["time_utc"]),
                    pct_missing=0.25) for r in rows]
    pcatalog.write_catalog(str(tmp_path / "p.csv"), written)
    pd.DataFrame(written).to_csv(tmp_path / "j.csv", index=False)
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


@pytest.fixture(scope="module")
def lr_tree(tmp_path_factory):
    """Synthetic tree with the real sevirlr geometry (128^2, 25 frames)."""
    root = str(tmp_path_factory.mktemp("sevirlr_geom"))
    jsyn.make_synthetic_sevir(root, num_events=2, height=128, width=128,
                              raw_seq_len=25)
    return root


def _corrupt(kind, lr_tree, root):
    """The sevir_dir of a test_preflight.py corruption of lr_tree."""
    if kind in ("ok", "wrong_preset"):
        return lr_tree
    os.makedirs(root)
    df = pd.read_csv(os.path.join(lr_tree, "CATALOG.csv"))
    if kind == "missing_columns":
        os.makedirs(os.path.join(root, "data"))
        df = df.drop(columns=["pct_missing"])
    elif kind == "missing_files":
        os.makedirs(os.path.join(root, "data"))
    else:
        os.symlink(os.path.join(lr_tree, "data"), os.path.join(root, "data"))
        if kind == "all_missing":
            df["pct_missing"] = 0.5
        elif kind == "real_header":
            df = df.assign(minute_offsets=":".join(str(5 * i) for i in range(25)),
                           episode_id=11111, event_type="Thunderstorm Wind",
                           proj="laea", size_x=128, data_min=0.0, data_max="")
        elif kind == "bad_file_index":   # on a row the filter drops
            df["file_index"] = df["file_index"].astype(object)
            df.loc[0, "file_index"] = "abc"
            df.loc[0, "pct_missing"] = 0.5
    df.to_csv(os.path.join(root, "CATALOG.csv"), index=False)
    return root


PREFLIGHT = ["ok", "wrong_preset", "missing_columns", "missing_files",
             "real_header", "all_missing", "bad_file_index"]


@pytest.mark.parametrize("kind", PREFLIGHT)
def test_preflight_reports_agree(lr_tree, tmp_path, kind):
    root = _corrupt(kind, lr_tree, str(tmp_path / kind))
    preset = "sevir" if kind == "wrong_preset" else "sevirlr"
    jrep = jpre.preflight(root, dataset_name=preset, strict=False)
    prep = ppre.preflight(root, dataset_name=preset, strict=False)
    assert (prep.errors, prep.warnings, prep.info) == \
        (jrep.errors, jrep.warnings, jrep.info)
    assert prep.ok == (kind in ("ok", "real_header"))
    assert prep.summary() == jrep.summary()
    if not prep.ok:
        with pytest.raises(ppre.PreflightError):
            ppre.preflight(root, dataset_name=preset)


def test_datamodule_runs_preflight(lr_tree):
    kw = dict(sevir_dir=lr_tree, seq_len=13, stride=12, run_preflight=True,
              train_test_split_date=None)
    pdm.SEVIRDataModule(dataset_name="sevirlr", **kw).prepare_data()
    with pytest.raises(ppre.PreflightError):
        pdm.SEVIRDataModule(dataset_name="sevir", **kw).prepare_data()


# -- download: tests/test_download.py's cases, against the port -------------
def test_download_file_atomic_and_skip(server, tmp_path):
    base, handler = server({"a.bin": b"x" * 5000})
    dest = str(tmp_path / "out" / "a.bin")
    assert pdl.download_file(base + "/a.bin", dest) == dest
    assert open(dest, "rb").read() == b"x" * 5000
    assert not os.path.exists(dest + ".part")
    hits = len(handler.hits)
    pdl.download_file(base + "/a.bin", dest)
    assert len(handler.hits) == hits  # published file -> no request at all


@pytest.mark.parametrize("support_range", [True, False])
def test_download_file_resumes(server, tmp_path, support_range):
    body = bytes(range(256)) * 40
    base, handler = server({"a.bin": body}, support_range=support_range)
    dest = str(tmp_path / "a.bin")
    open(dest + ".part", "wb").write(body[:1000] if support_range
                                     else b"garbage-prefix")
    pdl.download_file(base + "/a.bin", dest)
    assert open(dest, "rb").read() == body


def test_download_file_network_error(tmp_path):
    with pytest.raises(pdl.DownloadError, match="aws s3 cp"):
        pdl.download_file("http://127.0.0.1:1/nope", str(tmp_path / "x"),
                          timeout=0.5)
    assert not os.path.exists(tmp_path / "x")


def test_download_sevir_lists_and_fetches(server, tmp_path):
    objs = {"CATALOG.csv": b"id,file_name\n1,f.h5\n",
            **{f"data/vil/20{i:02d}/f.h5": b"d" * i for i in range(1, 6)},
            "data/ir069/x.h5": b"other"}
    base, handler = server(objs)
    got = pdl.list_s3_prefix(base, "data/vil")
    assert sorted(k for k, _ in got) == sorted(k for k in objs
                                               if k.startswith("data/vil"))
    assert len([h for h in handler.hits if "list-type" in h]) == 3
    root = pdm.download_sevir(str(tmp_path), base_url=base)
    assert root == str(tmp_path / "sevir")
    for key, body in objs.items():
        path = os.path.join(root, *key.split("/"))
        assert key.startswith("data/ir069") != os.path.exists(path)
        if os.path.exists(path):
            assert open(path, "rb").read() == body


def test_download_sevirlr_flattens_zip(server, tmp_path):
    import io
    import zipfile

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("sevir_lr/CATALOG.csv", "id\n9\n")
        zf.writestr("sevir_lr/data/vil/2019/a.h5", "payload")
    base, _ = server({"datasets/sevir_lr.zip": buf.getvalue()})
    root = pdm.download_sevirlr(str(tmp_path),
                                url=base + "/datasets/sevir_lr.zip")
    assert open(os.path.join(root, "CATALOG.csv")).read() == "id\n9\n"
    assert open(os.path.join(root, "data", "vil", "2019", "a.h5")).read() == \
        "payload"
    assert not os.path.exists(os.path.join(root, "sevir_lr.zip"))
    assert pdm.download_sevirlr(str(tmp_path), url=base + "/zzz") == root


# -- the cache-build race (tests/test_cache_race.py, against the port) ------
CHILD = """
import hashlib, sys
sys.path.insert(0, {repo!r})
from weatherforecastingtoolkit_tpu_torch.data.datamodule import SEVIRDataModule

dm = SEVIRDataModule(dataset_name="sevirlr", sevir_dir={root!r}, seq_len=13,
                     stride=12, layout="NTCHW", batch_size=2, num_workers=0,
                     use_cache=True, num_shard=2, rank={rank},
                     train_test_split_date=None)
dm.prepare_data()
dm.setup(stage="fit")
h = hashlib.sha256()
ds = dm.sevir_train
for i in range(min(len(ds), 4)):
    h.update(ds[i]["vil"].tobytes())
print("DIGEST", {rank}, h.hexdigest())
"""


def test_concurrent_cache_build_is_single(tmp_path):
    root = str(tmp_path / "sevir")
    jsyn.make_synthetic_sevir(root, num_events=6, height=32, width=32,
                              raw_seq_len=25)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD.format(repo=str(REPO), root=root,
                                            rank=r)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"child failed:\n{out}\n{err}"
        outs.append(out)
    assert sum(o.count("[cache] building") for o in outs) == 1
    cache_dir = os.path.join(root, "cache_packed")
    assert not [f for f in os.listdir(cache_dir) if f.startswith(".")]
    digests = {int(line.split()[1]): line.split()[2] for o in outs
               for line in o.splitlines() if line.startswith("DIGEST")}
    assert set(digests) == {0, 1}
    # each rank's samples are the JAX package's for that rank
    for rank, digest in digests.items():
        dm = jdm.SEVIRDataModule(dataset_name="sevirlr", sevir_dir=root,
                                 seq_len=13, stride=12, num_workers=0,
                                 num_shard=2, rank=rank,
                                 train_test_split_date=None)
        dm.setup(stage="fit")
        h = hashlib.sha256()
        for i in range(min(len(dm.sevir_train), 4)):
            h.update(dm.sevir_train[i]["vil"].tobytes())
        assert h.hexdigest() == digest, rank


def test_stale_lock_is_stolen(tmp_path):
    root = str(tmp_path / "sevir")
    jsyn.make_synthetic_sevir(root, num_events=4, height=32, width=32,
                              raw_seq_len=25)
    cache_dir = os.path.join(root, "cache_packed")
    os.makedirs(cache_dir)
    lock = os.path.join(cache_dir, ".train.build_lock")
    Path(lock).write_text("99999")
    old = os.path.getmtime(lock) - 7200
    os.utime(lock, (old, old))
    dm = pdm.SEVIRDataModule(dataset_name="sevirlr", sevir_dir=root,
                             seq_len=13, stride=12, num_workers=0,
                             use_cache=True, train_test_split_date=None)
    dm.prepare_data()
    dm.setup(stage="fit")
    assert len(dm.sevir_train) > 0
    assert not os.path.exists(lock)


# -- host-side helpers ---------------------------------------------------------
def test_host_helpers_match(tree, tmp_path):
    rng = np.random.default_rng(0)
    # windows
    for total, shards in ((10, 3), (12, 4), (7, 2)):
        for mode in ("ceil", "floor", "uneven"):
            for r in range(shards):
                assert (pwin.shard_event_range(total, shards, r, mode)
                        == jwin.shard_event_range(total, shards, r, mode))
    wi = (49, 13, 12)
    assert pwin.num_seq_per_event(*wi) == jwin.num_seq_per_event(*wi)
    pw, jw = pwin.WindowIndex(5, *wi, start_event_idx=2), \
        jwin.WindowIndex(5, *wi, start_event_idx=2)
    assert [pw.locate(i) for i in range(len(pw))] == \
        [jw.locate(i) for i in range(len(jw))]
    assert pw.batch_locate(3, 6) == jw.batch_locate(3, 6)
    # lightning rasterization
    pts = np.stack([rng.uniform(-8000, 8000, 300), np.zeros(300),
                    np.zeros(300), rng.integers(-3, 52, 300),
                    rng.integers(-3, 52, 300)], axis=1)
    _same({"g": jhdf5.lght_to_grid(pts)}, {"g": phdf5.lght_to_grid(pts)},
          "lght")
    # rescale, downsampling, augmentation
    raw = rng.integers(0, 256, (16, 16, 6)).astype(np.uint8)
    for method in ("01", "sevir", "01_uint8"):
        a = pdataset.preprocess_array(raw, "vil", method)
        _same({"x": jdataset.preprocess_array(raw, "vil", method)}, {"x": a},
              method)
        _same({"x": jdataset.process_back(a, "vil", method)},
              {"x": pdataset.process_back(a, "vil", method)}, method)
    for method in ("avg", "max"):
        _same({"x": jdataset.downsample_hwt(raw, 2, 2, 4, method)},
              {"x": pdataset.downsample_hwt(raw, 2, 2, 4, method)}, method)
    x = rng.random((4, 16, 16)).astype(np.float32)
    for mode in ("0", "1", "2"):
        for interp in ("nearest", "bilinear"):
            _same({"x": jdataset.augment_thw(x, mode, np.random.default_rng(4),
                                             interp)},
                  {"x": pdataset.augment_thw(x, mode, np.random.default_rng(4),
                                             interp)}, mode + interp)
    # the streaming iterator (tail padding + mask) and random sampling
    kw = dict(data_types=("vil",), seq_len=8, raw_seq_len=25, stride=6)
    cat = os.path.join(tree, "CATALOG.csv")
    data = os.path.join(tree, "data")
    jd = jdataset.SEVIRDataset(cat, data, **kw)
    pds = pdataset.SEVIRDataset(cat, data, **kw)
    for mode in ("sequent", "random"):
        jit = jdataset.SEVIRSequentIterator(jd, 7, mode, seed=2)
        pit = pdataset.SEVIRSequentIterator(pds, 7, mode, seed=2)
        for i, (jb, pb) in enumerate(zip(jit, pit)):
            _same(jb, pb, f"{mode} {i}")
            if i == 6:
                break
    # the offline downsampled tree: same catalog bytes and arrays
    jd_full = jdataset.SEVIRDataset(cat, data, data_types=("vil", "lght"),
                                    seq_len=25, raw_seq_len=25, stride=25)
    pd_full = pdataset.SEVIRDataset(cat, data, data_types=("vil", "lght"),
                                    seq_len=25, raw_seq_len=25, stride=25)
    factors = {"vil": (2, 2, 2), "lght": (1, 2, 2)}
    jdown.save_downsampled_dataset(jd_full, str(tmp_path / "jd"), factors,
                                   events_per_file=4, verbose=False)
    pdown.save_downsampled_dataset(pd_full, str(tmp_path / "pd"), factors,
                                   events_per_file=4, verbose=False)
    assert ((tmp_path / "jd" / "CATALOG.csv").read_bytes()
            == (tmp_path / "pd" / "CATALOG.csv").read_bytes())
    for p in sorted((tmp_path / "jd").rglob("*.h5")):
        rel = p.relative_to(tmp_path / "jd")
        import h5py
        with h5py.File(p, "r") as a, h5py.File(tmp_path / "pd" / rel, "r") as b:
            assert sorted(a) == sorted(b)
            for k in a:
                _same({k: a[k][()]}, {k: b[k][()]}, str(rel))


def test_measure_loader_and_profiling(tree, tmp_path):
    ds = pdataset.SEVIRDataset(os.path.join(tree, "CATALOG.csv"),
                               os.path.join(tree, "data"), seq_len=8,
                               raw_seq_len=25, stride=6)
    loader = pdm.BatchLoader(ds, 2, num_workers=1)
    bps, sps = pbench.measure_loader(loader, max_batches=3, warmup=1)
    assert bps > 0 and sps == pytest.approx(2 * bps)
    from weatherforecastingtoolkit_tpu_torch.data.prefetch import (
        device_prefetch)
    bps, sps = pbench.measure_loader(device_prefetch(loader, device="cpu"),
                                     max_batches=3, warmup=1)
    assert bps > 0
    timer = pprof.StepTimer()
    for _ in range(2):
        with timer.phase("load"):
            next(iter(loader))
    assert "load" in timer.report().splitlines()[1]
    with pprof.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof.key_averages() is not None
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pprof.device_memory_stats()


# -- what the data layer may import ------------------------------------------
def _port_files():
    files = sorted((REPO / "weatherforecastingtoolkit_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "experiments_gpu").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_no_pandas_and_no_module_level_h5py(tree, tmp_path):
    """No import of pandas anywhere in the port, experiments_gpu/ or
    chip_smoke.py, and h5py imported only inside functions; with h5py and
    pandas unimportable, a fresh interpreter imports the data module and
    trains from a packed cache."""
    bad = []
    for path in _port_files():
        module = ast.parse(path.read_text())
        in_functions = {id(n) for f in ast.walk(module)
                        if isinstance(f, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        for n in ast.walk(f)}
        for node in ast.walk(module):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top == "pandas" or (top == "h5py"
                                       and id(node) not in in_functions):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} {n}")
    assert not bad
    # the JAX package builds the tree's packed cache; the port reads it
    root = str(tmp_path / "tree")
    shutil.copytree(tree, root)
    jm = jdm.SEVIRDataModule(sevir_dir=root, seq_len=8, stride=6,
                             batch_size=2, num_workers=1, use_cache=True)
    jm.prepare_data()
    jm.setup()
    want = hashlib.sha256(next(iter(jm.train_loader()))["vil"].tobytes())
    code = f"""
import hashlib, sys
sys.modules["h5py"] = None
sys.modules["pandas"] = None
sys.path.insert(0, {str(REPO)!r})
from weatherforecastingtoolkit_tpu_torch.data.datamodule import SEVIRDataModule
import weatherforecastingtoolkit_tpu_torch.data.preflight
import weatherforecastingtoolkit_tpu_torch.data.downsample_writer
import weatherforecastingtoolkit_tpu_torch.data.benchmark
dm = SEVIRDataModule(sevir_dir={root!r}, seq_len=8, stride=6, batch_size=2,
                     num_workers=1, use_cache=True)
dm._build_cache_once = None
dm.prepare_data()
dm.setup()
print("DIGEST", hashlib.sha256(next(iter(dm.train_loader()))["vil"].tobytes()).hexdigest())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert f"DIGEST {want.hexdigest()}" in out.stdout


def test_lazy_data_aliases():
    import weatherforecastingtoolkit_tpu_torch as port

    assert port.SEVIRDataModule is pdm.SEVIRDataModule
    assert port.SEVIRDataset is pdataset.SEVIRDataset
