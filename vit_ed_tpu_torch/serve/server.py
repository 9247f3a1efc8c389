"""HTTP serving host over an exported bundle (``vit_ed_tpu/serve/server.py``).

The deployment unit is a bundle directory (serve/export.py) and this host:
a stdlib ``ThreadingHTTPServer`` that replays the exported stages with no
model code and no config system; torch and the port's ops library are all
the serving box needs.

Endpoints (wire format: ``.npz`` bodies, arrays keyed ``in0..inN`` per the
stage signature in ``serving_meta.json``; responses ``{"out": ...}``; JSON
for control endpoints), the JAX host's:

    GET  /healthz             liveness
    GET  /v1/meta             the bundle's serving_meta.json
    GET  /v1/stats            request / device-call / batching counters
    POST /v1/score            the full pair forward (alias of stage pair)
    POST /v1/stage/<stage>    any exported stage

Two serving-host concerns the compute path does not own:

- **dynamic micro-batching**: concurrent requests to single-input stages
  coalesce into one device call (the card wants large batches; HTTP
  clients send small ones). The host pads the merged batch up to a
  servable size (a bucket, or the next power of two) and truncates
  per-request results, mirroring ``parallel/pairs.py``'s fixed-shape chunk
  policy on the training side.
- **one device client**: every device call serializes behind one lock.

The wire is plain numpy, which has no bfloat16 where torch runs without
ml_dtypes: incoming arrays are cast to a stage's dtypes with torch, and
bfloat16 outputs are widened to float32 (exact) before they are sent.
"""

from __future__ import annotations

import argparse
import io
import json
import re
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, SimpleQueue
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from vit_ed_tpu_torch.serve.export import ExportedScorer, load_scorer

__all__ = ["BundleServer", "DynamicBatcher", "main"]


class DynamicBatcher:
    """Coalesce concurrent single-input requests into one device call.

    ``call(x)`` must be batched on axis 0 of the tensor ``x``; ``bucket(b)``
    maps a merged request count to the padded batch actually sent to the
    device. A worker thread groups queued requests until ``max_batch`` is
    reached or ``max_wait_ms`` elapses after the first request of the
    group, then runs ONE padded call and scatters the sliced results back to
    each request's future. A request that would take a group past
    ``max_batch`` starts the next group instead.
    """

    def __init__(self, call: Callable, bucket: Callable[[int], int] = None,
                 *, max_batch: int = 64, max_wait_ms: float = 5.0,
                 start: bool = True):
        self._call = call
        self._bucket = bucket or (lambda b: b)
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self.requests = 0
        self.device_calls = 0
        self._q: SimpleQueue = SimpleQueue()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        if start:
            self._thread.start()

    def start(self):
        self._thread.start()

    def submit(self, x) -> Future:
        if self._closed:
            raise RuntimeError("batcher is closed")
        x = torch.as_tensor(x)
        if x.ndim < 1:
            raise ValueError("batched stage input must have a batch axis")
        fut: Future = Future()
        self._q.put((x, fut))
        return fut

    def close(self):
        self._closed = True
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()

    def _loop(self):
        stop = False
        carry = None  # request that would overflow the previous group
        while not stop:
            if carry is not None:
                item, carry = carry, None
            else:
                item = self._q.get()
            if item is None:
                return
            group = [item]
            total = item[0].shape[0]
            deadline = time.monotonic() + self.max_wait
            while total < self.max_batch:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=wait)
                except Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                if total + nxt[0].shape[0] > self.max_batch:
                    carry = nxt  # starts the next group: never merge a
                    break        # group past max_batch / the largest bucket
                group.append(nxt)
                total += nxt[0].shape[0]
            self._run(group, total)
        if carry is not None:  # sentinel arrived while a carry was pending
            self._run([carry], carry[0].shape[0])

    def _run(self, group, total):
        sizes = [a.shape[0] for a, _ in group]
        try:
            padded = self._bucket(total)
            x = torch.cat([a for a, _ in group]) if len(group) > 1 \
                else group[0][0]
            if padded != total:
                x = torch.cat([x, x.new_zeros((padded - total,) + x.shape[1:])])
            out = self._call(x)
            self.device_calls += 1
            self.requests += len(group)
        except Exception as e:  # noqa: BLE001 — scattered to the callers
            for _, fut in group:
                fut.set_exception(e)
            return
        off = 0
        for (_, fut), n in zip(group, sizes):
            fut.set_result(out[off:off + n])
            off += n


class _Handler(BaseHTTPRequestHandler):
    server_version = "vit-ed-serve-torch/1"
    # self.server is the BundleServer's httpd; bundle state hangs off it

    def log_message(self, fmt, *args):  # keep stdout clean; tests parse it
        pass

    def _json(self, code: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _npz(self, out: torch.Tensor):
        out = out.detach()
        if out.dtype == torch.bfloat16:
            # numpy has no bfloat16 for a plain client; f32 widening is exact
            out = out.float()
        buf = io.BytesIO()
        np.savez(buf, out=out.cpu().numpy())
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "application/x-npz")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        srv = self.server.bundle  # type: ignore[attr-defined]
        if self.path == "/healthz":
            self._json(200, {"ok": True})
        elif self.path == "/v1/meta":
            self._json(200, srv.scorer.meta)
        elif self.path == "/v1/stats":
            self._json(200, srv.stats())
        else:
            self._json(404, {"error": f"no such endpoint: {self.path}"})

    def do_POST(self):  # noqa: N802
        srv = self.server.bundle  # type: ignore[attr-defined]
        m = re.fullmatch(r"/v1/(?:score|stage/([a-z0-9_]+))", self.path)
        if not m:
            return self._json(404, {"error": f"no such endpoint: {self.path}"})
        stage = m.group(1) or "pair"
        if stage not in srv.scorer.stages():
            return self._json(
                404, {"error": f"stage {stage!r} not in bundle; have "
                               f"{srv.scorer.stages()}"})
        try:
            n = int(self.headers.get("Content-Length", 0))
            with np.load(io.BytesIO(self.rfile.read(n)),
                         allow_pickle=False) as z:
                n_in = len(srv.scorer.meta["stages"][stage][0]["inputs"])
                try:
                    arrays = [z[f"in{i}"] for i in range(n_in)]
                except KeyError:
                    return self._json(
                        400, {"error": f"stage {stage!r} takes {n_in} "
                                       f"input(s) in0..in{n_in - 1}; body "
                                       f"has {sorted(z.files)}"})
        except (ValueError, OSError) as e:
            return self._json(400, {"error": f"bad .npz body: {e}"})
        try:
            out = srv.call(stage, arrays)
        except ValueError as e:  # batch/bucket mismatches and kin
            return self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — surfaced, not swallowed
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})
        self._npz(out)


class BundleServer:
    """Serve an ``ExportedScorer`` over HTTP with dynamic batching."""

    def __init__(self, scorer: ExportedScorer, host: str = "127.0.0.1",
                 port: int = 0, *, batch_stages: Sequence[str] = ("pair",),
                 max_batch: int = 64, max_wait_ms: float = 5.0):
        self.scorer = scorer
        self._lock = threading.Lock()  # one device client at a time
        self._direct_calls = 0
        mode = scorer.meta["batch_mode"]
        if mode != "symbolic":
            # group gathering is capped here AND in the batcher's carry
            # logic, so a merged group never exceeds the largest bucket
            max_batch = min(max_batch, mode[-1])
        self.batchers: Dict[str, DynamicBatcher] = {}
        for stage in batch_stages:
            if stage not in scorer.stages():
                continue
            ent = scorer.meta["stages"][stage][0]
            out_axis = ent["out_batch_axis"]
            if len(ent["inputs"]) != 1 or ent["batch_axes"] != [0] \
                    or out_axis != 0:
                raise ValueError(
                    f"stage {stage!r} cannot be dynamically batched: it "
                    "needs one input and batch axis 0 on both input and "
                    f"output (output batch axis: {out_axis})")
            self.batchers[stage] = DynamicBatcher(
                self._locked(stage), scorer.servable_batch,
                max_batch=max_batch, max_wait_ms=max_wait_ms)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.bundle = self  # type: ignore[attr-defined]
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def _locked(self, stage):
        def call(*arrays):
            with self._lock:
                return self.scorer(stage, *arrays)
        return call

    def call(self, stage: str, arrays):
        arrays = self._check_and_cast(stage, arrays)
        if stage in self.batchers and len(arrays) == 1:
            # bounded wait so a shutdown race can never hang a handler
            return self.batchers[stage].submit(arrays[0]).result(
                timeout=600.0)
        with self._lock:
            self._direct_calls += 1
            return self.scorer(stage, *arrays)

    def _check_and_cast(self, stage, arrays):
        """Validate each wire array against the stage's exported signature
        and cast it, with torch, to the signature's dtype. Validating
        BEFORE the batcher means a malformed request fails alone: it can
        never poison the group it would have been coalesced into."""
        sig = self.scorer.meta["stages"][stage][0]
        out = []
        for k, (a, ent, ax) in enumerate(
                zip(arrays, sig["inputs"], sig["batch_axes"])):
            dims, dname = ent[:-1], ent[-1]
            if a.ndim != len(dims):
                raise ValueError(
                    f"stage {stage!r} input {k} must have {len(dims)} "
                    f"dims {dims}, got shape {list(a.shape)}")
            for i, d in enumerate(dims):
                if i != ax and d.isdigit() and a.shape[i] != int(d):
                    raise ValueError(
                        f"stage {stage!r} input {k} dim {i} must be {d}, "
                        f"got {a.shape[i]} (signature {dims})")
            t = torch.from_numpy(np.ascontiguousarray(a))
            dtype = getattr(torch, dname)
            out.append(t if t.dtype == dtype else t.to(dtype))
        return out

    def stats(self) -> dict:
        return {
            "direct_calls": self._direct_calls,
            "batched": {s: {"requests": b.requests,
                            "device_calls": b.device_calls}
                        for s, b in self.batchers.items()},
        }

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self):
        """Serve on a background thread (tests / embedding)."""
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        for b in self.batchers.values():
            b.close()
        if self._thread is not None:
            self._thread.join()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve an exported vit-ed bundle over HTTP")
    ap.add_argument("--bundle", required=True,
                    help="bundle directory from python -m "
                         "vit_ed_tpu_torch.export_serving")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8476)
    ap.add_argument("--batch-stages", nargs="*", default=["pair"],
                    help="stages to dynamically micro-batch")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="data-axis size for multi-chip bundles (not ported "
                         "yet: any value > 0 raises)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    scorer = load_scorer(args.bundle, device=args.device,
                         mesh=args.mesh_data or None)
    server = BundleServer(scorer, args.host, args.port,
                          batch_stages=args.batch_stages,
                          max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms)
    print(f"serving {sorted(scorer.stages())} on {server.url}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
