"""Client for the bundle serving host (serve/server.py): stdlib and numpy
only (``vit_ed_tpu/serve/client.py``; the wire is the same, so this client
also talks to the JAX host and the JAX client to this one).

A consumer of the deployed scorer needs numpy and this file; torch and the
model code stay on the serving box. Wire format: ``.npz`` request bodies
keyed ``in0..inN``, ``.npz`` responses keyed ``out``; JSON control
endpoints.
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.request

import numpy as np

__all__ = ["ServeClient", "ServeError"]


class ServeError(RuntimeError):
    """Server-reported request failure (carries the HTTP status)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"[{status}] {message}")
        self.status = status


class ServeClient:
    def __init__(self, base_url: str, timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _request(self, path: str, body: bytes = None,
                 content_type: str = None):
        req = urllib.request.Request(self.base_url + path, data=body)
        if content_type:
            req.add_header("Content-Type", content_type)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read(), r.headers.get_content_type()
        except urllib.error.HTTPError as e:
            detail = e.read()
            try:
                msg = json.loads(detail)["error"]
            except Exception:  # noqa: BLE001 — non-JSON error body
                msg = detail.decode(errors="replace")
            raise ServeError(e.code, msg) from None

    def _get_json(self, path: str):
        body, _ = self._request(path)
        return json.loads(body)

    def health(self) -> dict:
        return self._get_json("/healthz")

    def meta(self) -> dict:
        return self._get_json("/v1/meta")

    def stats(self) -> dict:
        return self._get_json("/v1/stats")

    def stage(self, name: str, *arrays) -> np.ndarray:
        buf = io.BytesIO()
        np.savez(buf, **{f"in{i}": np.asarray(a)
                         for i, a in enumerate(arrays)})
        body, _ = self._request(f"/v1/stage/{name}", buf.getvalue(),
                                "application/x-npz")
        with np.load(io.BytesIO(body), allow_pickle=False) as z:
            return z["out"]

    def score(self, x) -> np.ndarray:
        """Full pair forward: x [b, 2, H, W, 3] -> [b, classes]."""
        return self.stage("pair", x)
