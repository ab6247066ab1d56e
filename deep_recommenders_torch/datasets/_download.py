"""Fetching a corpus archive: ``fetch`` streams a URL into
``<path>.part`` and renames it into place, so an interrupted download
never leaves a file that looks whole."""

from __future__ import annotations

import os
import urllib.request

_CHUNK = 1 << 20


def fetch(url: str, path: str, timeout: float) -> None:
    """Download ``url`` to ``path`` unless ``path`` exists. ``OSError``
    (``urllib.error.URLError`` among them) when the URL is unreachable."""
    if os.path.exists(path):
        return
    tmp = path + ".part"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, \
                open(tmp, "wb") as f:
            while True:
                chunk = r.read(_CHUNK)
                if not chunk:
                    break
                f.write(chunk)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    os.replace(tmp, path)
