"""SEVIR dataset auto-download — stdlib HTTP, resumable, atomic (a copy of
weatherforecastingtoolkit_tpu/data/download.py).

Capability parity with the reference's download helpers
(reference pipeline/datasets/sevir/sevir.py:930-977), redesigned to drop
the external-tool dependencies the reference shells out to:

- ``download_SEVIR`` there runs ``aws s3 cp --no-sign-request --recursive``
  (requires the AWS CLI). The ``sevir`` bucket is public, so here we speak
  the S3 REST API directly: anonymous ``GET ?list-type=2`` XML listings to
  enumerate ``data/<type>/`` objects, then plain HTTPS GETs — no aws cli.
- ``download_SEVIRLR`` there runs ``wget`` + ``unzip`` + ``mv``; here it is
  one resumable GET plus :mod:`zipfile` extraction with the same
  ``sevir_lr/``-folder flattening.

Robustness the reference lacks (its ``os.system`` calls ignore failures):

- every file downloads to ``<dest>.part`` and is published with an atomic
  ``os.replace`` — an interrupted run never leaves a truncated file where
  a complete one should be;
- interrupted ``.part`` files resume with an HTTP ``Range`` header when the
  server supports it (S3 does), restart from zero otherwise;
- ``Content-Length`` is verified after each transfer;
- network failures raise :class:`DownloadError` with the manual-fetch
  instructions (see docs/real_sevir.md).

Tested against the local mock S3 server of tests/test_download.py
(tests/test_torch_port_data.py): full fetch, mid-file resume, S3 listing
pagination, zip flattening, and the failure message.
"""

from __future__ import annotations

import os
import posixpath
import shutil
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
import zipfile
from typing import Callable, List, Optional, Sequence, Tuple

SEVIR_BASE_URL = "https://sevir.s3.amazonaws.com"
SEVIRLR_URL = "https://deep-earth.s3.amazonaws.com/datasets/sevir_lr.zip"
_CHUNK = 1 << 20  # 1 MiB read granularity

ProgressFn = Callable[[str, int, Optional[int]], None]


class DownloadError(RuntimeError):
    """A transfer failed; the message includes manual-fetch instructions."""


def _open(url: str, headers: Optional[dict] = None, timeout: float = 60.0):
    req = urllib.request.Request(url, headers=headers or {})
    return urllib.request.urlopen(req, timeout=timeout)  # noqa: S310 — https/test URLs


def download_file(url: str, dest: str, resume: bool = True,
                  progress: Optional[ProgressFn] = None,
                  timeout: float = 60.0) -> str:
    """Fetch ``url`` to ``dest`` (atomic; resumes a partial ``.part``).

    Returns ``dest``. Raises :class:`DownloadError` on network failure or a
    short read (Content-Length mismatch).
    """
    if os.path.exists(dest):
        return dest  # already published (atomic rename ⇒ complete)
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    part = dest + ".part"
    offset = os.path.getsize(part) if (resume and os.path.exists(part)) else 0
    headers = {"Range": f"bytes={offset}-"} if offset else {}
    try:
        try:
            resp = _open(url, headers, timeout)
        except urllib.error.HTTPError as e:
            if offset and e.code in (416, 200):  # range unsatisfiable/ignored
                offset = 0
                resp = _open(url, {}, timeout)
            else:
                raise
        with resp:
            if offset and resp.status != 206:
                offset = 0  # server ignored Range — restart from zero
            total = resp.headers.get("Content-Length")
            expect = (int(total) + offset) if total is not None else None
            mode = "ab" if offset else "wb"
            done = offset
            with open(part, mode) as f:
                if offset:
                    f.seek(offset)
                    f.truncate()
                while True:
                    buf = resp.read(_CHUNK)
                    if not buf:
                        break
                    f.write(buf)
                    done += len(buf)
                    if progress is not None:
                        progress(dest, done, expect)
        if expect is not None and os.path.getsize(part) != expect:
            raise DownloadError(
                f"short read for {url}: got {os.path.getsize(part)} bytes, "
                f"expected {expect} (resume by re-running; .part kept)")
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        if isinstance(e, DownloadError):
            raise
        raise DownloadError(
            f"download failed for {url}: {e}. If this environment has no "
            "egress, fetch manually (SEVIR: `aws s3 cp --no-sign-request "
            "--recursive s3://sevir ...`; SEVIR-LR: " + SEVIRLR_URL +
            ") and point sevir_dir at the result. Partial .part files "
            "resume on retry.") from e
    os.replace(part, dest)
    return dest


def list_s3_prefix(base_url: str, prefix: str,
                   timeout: float = 60.0) -> List[Tuple[str, int]]:
    """Enumerate (key, size) under ``prefix`` via anonymous S3 ListObjectsV2.

    Follows continuation tokens across pages (S3 caps each page at 1000
    keys; SEVIR's vil tree is ~800 files but other types exceed a page).
    """
    out: List[Tuple[str, int]] = []
    token: Optional[str] = None
    while True:
        q = {"list-type": "2", "prefix": prefix}
        if token:
            q["continuation-token"] = token
        url = base_url.rstrip("/") + "/?" + urllib.parse.urlencode(q)
        try:
            with _open(url, timeout=timeout) as resp:
                tree = ET.fromstring(resp.read())
        except (urllib.error.URLError, OSError, ET.ParseError) as e:
            raise DownloadError(
                f"S3 listing failed for {url}: {e}. Fetch manually with "
                "`aws s3 cp --no-sign-request --recursive` instead.") from e
        ns = ""
        if tree.tag.startswith("{"):
            ns = tree.tag[:tree.tag.index("}") + 1]
        for c in tree.iter(ns + "Contents"):
            key = c.findtext(ns + "Key")
            size = int(c.findtext(ns + "Size") or 0)
            if key and not key.endswith("/"):
                out.append((key, size))
        if (tree.findtext(ns + "IsTruncated") or "").lower() == "true":
            token = tree.findtext(ns + "NextContinuationToken")
            if not token:
                break
        else:
            break
    return out


def download_sevir(save_dir: str, data_types: Sequence[str] = ("vil",),
                   base_url: str = SEVIR_BASE_URL,
                   progress: Optional[ProgressFn] = None) -> str:
    """Fetch CATALOG.csv + ``data/<type>/**`` into ``save_dir/sevir``.

    Reference behavior (sevir.py:937-956): catalog + the vil tree via the
    aws cli, refusing an existing target. Here an existing target is fine —
    completed files are skipped and partial ones resumed, so an interrupted
    ~1 TB fetch continues instead of starting over.
    """
    root = os.path.join(save_dir, "sevir")
    os.makedirs(root, exist_ok=True)
    download_file(base_url.rstrip("/") + "/CATALOG.csv",
                  os.path.join(root, "CATALOG.csv"), progress=progress)
    for t in data_types:
        for key, _size in list_s3_prefix(base_url, f"data/{t}"):
            rel = posixpath.normpath(key)
            if rel.startswith(("..", "/")):
                continue  # defensive: never escape root
            download_file(base_url.rstrip("/") + "/" + urllib.parse.quote(key),
                          os.path.join(root, *rel.split("/")),
                          progress=progress)
    return root


def download_sevirlr(save_dir: str, url: str = SEVIRLR_URL,
                     progress: Optional[ProgressFn] = None,
                     keep_zip: bool = False) -> str:
    """Fetch + extract sevir_lr.zip into ``save_dir/sevirlr``.

    Mirrors the reference's wget/unzip/mv flattening (sevir.py:959-977):
    the archive's top-level ``sevir_lr/`` folder is stripped so
    ``CATALOG.csv`` and ``data/`` land directly under the returned root.
    """
    root = os.path.join(save_dir, "sevirlr")
    os.makedirs(root, exist_ok=True)
    if os.path.exists(os.path.join(root, "CATALOG.csv")):
        return root  # already extracted
    zpath = os.path.join(root, "sevir_lr.zip")
    download_file(url, zpath, progress=progress)
    with zipfile.ZipFile(zpath) as zf:
        for info in zf.infolist():
            rel = posixpath.normpath(info.filename)
            parts = rel.split("/")
            if parts and parts[0] == "sevir_lr":
                parts = parts[1:]  # strip the wrapper folder
            if not parts or rel.startswith(("..", "/")):
                continue
            target = os.path.join(root, *parts)
            if info.is_dir():
                os.makedirs(target, exist_ok=True)
                continue
            os.makedirs(os.path.dirname(target), exist_ok=True)
            with zf.open(info) as src, open(target, "wb") as dst:
                shutil.copyfileobj(src, dst)
    if not keep_zip:
        os.unlink(zpath)
    return root
