"""URL/file access helpers with an offline-first cache.

The port's own copy of ``gantrack_tpu/utils/url.py`` (framework-free;
``tests/test_torch_utils.py`` holds the two equal).

Capability parity with the reference ``dnnlib/util.py:390-497``
(``is_url`` / ``open_url``: local paths pass through, ``file://`` URLs
resolve to paths, http(s) URLs are md5-cached under a cache dir, with
retrying download) — redesigned for air-gapped hosts:

* the md5 cache is consulted *first*, so pre-seeded caches work with no
  network at all (the deployment story for detector weights here);
* ``GANTRACK_URL_MIRROR`` may name a directory (or ``|``-separated
  directories) searched by URL basename before any download is tried;
* the download path uses ``urllib`` with exponential backoff and raises
  a descriptive ``IOError`` naming the cache/mirror escape hatches when
  the network is unreachable.
"""

from __future__ import annotations

import glob
import hashlib
import io
import os
import re
import shutil
import time
import urllib.parse
import urllib.request
import uuid
from typing import Any, Union


def is_url(obj: Any, allow_file_urls: bool = False) -> bool:
    """True if ``obj`` is a syntactically valid http(s) URL string
    (reference ``dnnlib/util.py:390-405``)."""
    if not isinstance(obj, str) or "://" not in obj:
        return False
    if obj.startswith("file://"):
        return allow_file_urls
    try:
        res = urllib.parse.urlparse(obj)
        if res.scheme not in ("http", "https") or not res.netloc or "." not in res.netloc:
            return False
    except Exception:
        return False
    return True


def _default_cache_dir() -> str:
    return os.path.join(
        os.environ.get("GANTRACK_CACHE_DIR",
                       os.path.expanduser("~/.cache/gantrack")),
        "downloads",
    )


def _mirror_lookup(url: str) -> Union[str, None]:
    """Resolve ``url`` against ``GANTRACK_URL_MIRROR`` directories by
    basename (query strings stripped)."""
    mirrors = os.environ.get("GANTRACK_URL_MIRROR", "")
    if not mirrors:
        return None
    name = os.path.basename(urllib.parse.urlparse(url).path)
    if not name:
        return None
    for d in mirrors.split("|"):
        cand = os.path.join(d, name)
        if os.path.isfile(cand):
            return cand
    return None


def open_url(
    url: str,
    cache_dir: str = None,
    num_attempts: int = 10,
    verbose: bool = True,
    return_filename: bool = False,
    cache: bool = True,
) -> Any:
    """Open a local path, ``file://`` URL, or http(s) URL (cached).

    Returns a binary file object, or the resolved filename when
    ``return_filename``.  Same contract as the reference ``open_url``
    (``dnnlib/util.py:409-497``) minus the Google-Drive nag handling.
    """
    assert num_attempts >= 1
    assert not (return_filename and not cache)

    # No URL scheme: a local filename.
    if not re.match(r"^[a-z]+://", url):
        return url if return_filename else open(url, "rb")

    if url.startswith("file://"):
        filename = urllib.parse.urlparse(url).path
        if re.match(r"^/[a-zA-Z]:", filename):  # windows-style file:///c:/...
            filename = filename[1:]
        return filename if return_filename else open(filename, "rb")

    assert is_url(url), f"not a valid URL: {url!r}"

    if cache_dir is None:
        cache_dir = _default_cache_dir()
    url_md5 = hashlib.md5(url.encode("utf-8")).hexdigest()

    # Cache first: pre-seeded caches serve air-gapped hosts.
    if cache:
        hits = glob.glob(os.path.join(cache_dir, url_md5 + "_*"))
        if len(hits) == 1:
            return hits[0] if return_filename else open(hits[0], "rb")

    # Local mirror next.
    mirror = _mirror_lookup(url)
    if mirror is not None:
        if cache:
            os.makedirs(cache_dir, exist_ok=True)
            cached = os.path.join(cache_dir, url_md5 + "_" + os.path.basename(mirror))
            if not os.path.exists(cached):
                tmp = cached + "." + uuid.uuid4().hex + ".tmp"
                shutil.copyfile(mirror, tmp)
                os.replace(tmp, cached)  # atomic vs concurrent processes
            return cached if return_filename else open(cached, "rb")
        return mirror if return_filename else open(mirror, "rb")

    # Download with exponential backoff.
    err = None
    data = name = None
    for attempt in range(num_attempts):
        try:
            if verbose:
                print(f"Downloading {url} ...", flush=True)
            with urllib.request.urlopen(url, timeout=60) as res:
                data = res.read()
                if len(data) == 0:
                    raise IOError("no data received")
                m = re.search(r'filename="([^"]*)"',
                              res.headers.get("Content-Disposition", "") or "")
                name = m[1] if m else os.path.basename(urllib.parse.urlparse(url).path) or "download"
            break
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 - retry any transport error
            err = e
            if attempt + 1 < num_attempts:
                time.sleep(min(2.0**attempt, 30.0))
    if data is None:
        raise IOError(
            f"could not download {url} after {num_attempts} attempts ({err}); "
            f"on air-gapped hosts, pre-seed the cache dir ({cache_dir}) or set "
            f"GANTRACK_URL_MIRROR to a directory containing "
            f"{os.path.basename(urllib.parse.urlparse(url).path)!r}"
        )

    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        safe = re.sub(r"[^0-9a-zA-Z-._]", "_", name)
        cached = os.path.join(cache_dir, url_md5 + "_" + safe)
        tmp = cached + "." + uuid.uuid4().hex + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, cached)
        if return_filename:
            return cached
    return io.BytesIO(data)
