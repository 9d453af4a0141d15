"""Run-event notification hook.

The port's own copy of ``gantrack_tpu/utils/notify.py``.

Capability parity with the reference ``util_general.notification_ifttt``
(``genlib/utils/util_general.py:76-79``): POST a short info payload to a
webhook at run milestones (training done, abort, metric ready).

Generalised: the endpoint comes from ``--notify-url`` / the
``GANTRACK_NOTIFY_URL`` env var instead of a hard-coded key, and failures
never propagate (notification is best-effort; this environment has no
egress, so the default is a no-op).
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Optional


def notify(info: str, url: Optional[str] = None, timeout: float = 5.0) -> bool:
    """POST ``{"Info": info}``; returns True on success, never raises."""
    url = url or os.environ.get("GANTRACK_NOTIFY_URL")
    if not url:
        return False
    try:
        data = json.dumps({"Info": str(info)}).encode()
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout):
            return True
    except Exception:
        return False
