"""The port's HTTP serving host (vit_ed_tpu_torch/serve/server.py,
client.py) against the JAX package's (tests/test_serve_http.py) on the CPU:
bundle replay over the wire equals direct scorer calls and the JAX
``stage_fns`` on the same params (f32 within 1e-5, bf16 staged within 2e-2,
the JAX tests' bounds); dynamic micro-batching coalesces concurrent
requests into fewer padded device calls, never past ``max_batch``; error
paths map to clean HTTP statuses; and the wire is the JAX host's: each
package's client talks to the other package's host.

One module-scoped host serves the port bundle; the servers bind port 0.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu.serve import BundleServer as JaxBundleServer
from vit_ed_tpu.serve import ServeClient as JaxServeClient
from vit_ed_tpu.serve import export_scorer as jax_export_scorer
from vit_ed_tpu.serve import load_scorer as jax_load_scorer
from vit_ed_tpu.serve import stage_fns as jax_stage_fns
from vit_ed_tpu_torch.models.convert import load_jax_params
from vit_ed_tpu_torch.models.vit_ed import ViTED
from vit_ed_tpu_torch.serve import (BundleServer, DynamicBatcher, ServeClient,
                                    ServeError, export_scorer, load_scorer)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(img_size=32, patch_size=16, num_classes=4, embed_dim=128, depth=1,
          c_depth=2, num_heads=2)


@pytest.fixture(scope="module")
def tiny():
    jm = JaxViTED(**KW, use_pallas=False)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 2, 32, 32, 3)))["params"])
    return jm, params, load_jax_params(ViTED(**KW), params).eval()


@pytest.fixture(scope="module")
def bundle(tiny, tmp_path_factory):
    out = tmp_path_factory.mktemp("bundle")
    export_scorer(tiny[2], None, str(out), device="cpu")
    return out


@pytest.fixture(scope="module")
def served(bundle):
    server = BundleServer(load_scorer(str(bundle), device="cpu"), max_wait_ms=20.0)
    server.start()
    yield ServeClient(server.url), server
    server.shutdown()


def _live(tiny, stage, *arrays):
    jm, params, _ = tiny
    return np.asarray(jax_stage_fns(jm)[stage](params, *map(jnp.asarray, arrays)),
                      np.float32)


def test_health_meta_stats(served):
    client, _ = served
    assert client.health() == {"ok": True}
    meta = client.meta()
    assert meta["batch_mode"] == "symbolic"
    assert set(meta["stages"]) == {"pair", "pair_u8", "encode", "prepare", "kv",
                                   "score_row"}
    assert "pair" in client.stats()["batched"]


def test_score_matches_direct(served, tiny):
    client, _ = served
    rng = np.random.default_rng(0)
    for b in (1, 3):
        x = rng.normal(size=(b, 2, 32, 32, 3)).astype(np.float32)
        np.testing.assert_allclose(client.score(x), _live(tiny, "pair", x), atol=1e-5)


def test_staged_pipeline_over_http(served, tiny):
    """encode + kv once, prepare per column batch, score_row per row: the
    scan schedule, driven through the HTTP surface."""
    client, _ = served
    rng = np.random.default_rng(1)
    x1 = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    x2 = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    kv = client.stage("kv", client.stage("encode", x1))
    got = client.stage("score_row", kv, client.stage("prepare", x2))
    jm, params, _ = tiny
    fns = jax_stage_fns(jm)
    live = fns["score_row"](params, fns["kv"](params, fns["encode"](params, x1)),
                            fns["prepare"](params, x2))
    np.testing.assert_allclose(got, np.asarray(live), atol=1e-5)


def test_http_error_paths(served):
    client, _ = served
    with pytest.raises(ServeError, match=r"\[404\].*nope"):
        client.stage("nope", np.zeros((1, 2, 32, 32, 3), np.float32))
    with pytest.raises(ServeError, match=r"\[400\].*2 input"):
        client.stage("score_row", np.zeros((1, 1, 5, 32), np.float32))
    with pytest.raises(ServeError, match=r"\[400\]"):
        client._request("/v1/score", b"not an npz", "application/x-npz")
    with pytest.raises(ServeError, match=r"\[404\]"):
        client._get_json("/v1/nothing")


def test_dynamic_batcher_coalesces():
    """Three queued requests become ONE padded device call, each caller
    getting exactly its slice back."""
    calls = []

    def fake(x):
        calls.append(x.shape[0])
        return x * 2.0

    batcher = DynamicBatcher(fake, lambda b: -(-b // 8) * 8, max_batch=64,
                             max_wait_ms=50.0, start=False)
    xs = [torch.full((n, 3), float(i)) for i, n in enumerate((1, 2, 1))]
    futs = [batcher.submit(x) for x in xs]
    batcher.start()
    for x, fut in zip(xs, futs):
        assert torch.equal(fut.result(timeout=30), x * 2.0)
    batcher.close()
    assert calls == [8]  # one call, padded 4 -> 8
    assert batcher.device_calls == 1 and batcher.requests == 3


def test_dynamic_batcher_scatters_errors():
    def boom(x):
        raise RuntimeError("device on fire")

    batcher = DynamicBatcher(boom, max_wait_ms=10.0, start=False)
    futs = [batcher.submit(np.zeros((1,))) for _ in range(2)]
    batcher.start()
    for fut in futs:
        with pytest.raises(RuntimeError, match="device on fire"):
            fut.result(timeout=30)
    batcher.close()


def test_batcher_never_merges_past_max_batch():
    """Two batch-3 requests against max_batch 4 do NOT merge into an
    unservable batch-6 group: the second carries into its own group."""
    calls = []

    def fake(x):
        calls.append(x.shape[0])
        if x.shape[0] > 4:
            raise ValueError(f"batch {x.shape[0]} exceeds largest bucket 4")
        return x + 1.0

    def bucket(b):
        if b > 4:
            raise ValueError(f"batch {b} exceeds largest bucket 4")
        return 4

    batcher = DynamicBatcher(fake, bucket, max_batch=4, max_wait_ms=50.0, start=False)
    xs = [torch.full((3, 2), float(i)) for i in range(2)]
    futs = [batcher.submit(x) for x in xs]
    batcher.start()
    for x, fut in zip(xs, futs):
        assert torch.equal(fut.result(timeout=30), x + 1.0)
    batcher.close()
    assert calls == [4, 4]  # two padded groups, never one batch-6
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(np.zeros((1, 2)))


def test_concurrent_scores_are_batched(served, tiny):
    """Concurrent HTTP clients coalesce into no more device calls than
    requests, each result still its own."""
    client, server = served
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(1, 2, 32, 32, 3)).astype(np.float32) for _ in range(4)]
    got = [None] * len(xs)
    before = server.batchers["pair"].device_calls

    def worker(i):
        got[i] = client.score(xs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, x in zip(got, xs):
        np.testing.assert_allclose(g, _live(tiny, "pair", x), atol=1e-5)
    assert server.batchers["pair"].device_calls - before <= len(xs)


def test_bucketed_bundle_pads_through_batcher(tiny, tmp_path):
    """A bucketed bundle: the batcher pads a batch-3 request up to the
    4-bucket, and an over-bucket request is the client's 400."""
    export_scorer(tiny[2], None, str(tmp_path), batch_sizes=[4], stages=("pair",),
                  device="cpu")
    server = BundleServer(load_scorer(str(tmp_path), device="cpu"), max_wait_ms=5.0,
                          max_batch=32)
    assert server.batchers["pair"].max_batch == 4  # capped at the bucket
    server.start()
    try:
        client = ServeClient(server.url)
        rng = np.random.default_rng(3)
        x = rng.normal(size=(3, 2, 32, 32, 3)).astype(np.float32)
        np.testing.assert_allclose(client.score(x), _live(tiny, "pair", x), atol=1e-5)
        with pytest.raises(ServeError, match=r"\[400\].*bucket"):
            client.score(rng.normal(size=(5, 2, 32, 32, 3)).astype(np.float32))
    finally:
        server.shutdown()


def test_kv_stage_refuses_dynamic_batching(bundle):
    """kv's output batches on axis 1 ([L, b, Sk, 2C]): the server refuses to
    coalesce it."""
    scorer = load_scorer(str(bundle), device="cpu")
    assert scorer.meta["stages"]["kv"][0]["out_batch_axis"] == 1
    assert scorer.meta["stages"]["pair"][0]["out_batch_axis"] == 0
    with pytest.raises(ValueError, match="kv.*cannot be dynamically"):
        BundleServer(scorer, batch_stages=("kv",))


def test_malformed_request_fails_alone(served):
    client, _ = served
    with pytest.raises(ServeError, match=r"\[400\].*dim 2 must be 32"):
        client.score(np.zeros((1, 2, 64, 64, 3), np.float32))
    with pytest.raises(ServeError, match=r"\[400\].*must have 5 dims"):
        client.score(np.zeros((2, 32, 32, 3), np.float32))
    assert client.health() == {"ok": True}


def test_bf16_bundle_staged_round_trip(tmp_path):
    """bf16 signatures with a plain-numpy wire: the host casts float32 and
    float64 arrays to bf16 with torch and widens bf16 outputs to float32,
    so staged outputs feed later stages; against the JAX bf16 model."""
    jm = JaxViTED(**dict(KW, c_depth=1), use_pallas=False, dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                              jnp.zeros((1, 2, 32, 32, 3)))["params"])
    model = load_jax_params(ViTED(**dict(KW, c_depth=1), dtype=torch.bfloat16),
                            params).eval()
    meta = export_scorer(model, None, str(tmp_path),
                         stages=("encode", "kv", "prepare", "score_row"), device="cpu")
    assert meta["stages"]["score_row"][0]["inputs"][1][-1] == "bfloat16"
    server = BundleServer(load_scorer(str(tmp_path), device="cpu"), max_wait_ms=5.0)
    server.start()
    try:
        client = ServeClient(server.url)
        rng = np.random.default_rng(5)
        x1 = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
        x2 = rng.normal(size=(2, 32, 32, 3))          # float64 accepted too
        kv = client.stage("kv", client.stage("encode", x1))
        assert kv.dtype == np.float32                 # wire dtype, widened from bf16
        got = client.stage("score_row", kv, client.stage("prepare", x2))
        fns = jax_stage_fns(jm)
        live = fns["score_row"](params, fns["kv"](params, fns["encode"](
            params, jnp.asarray(x1))), fns["prepare"](params, jnp.asarray(x2, jnp.float32)))
        np.testing.assert_allclose(got, np.asarray(live, np.float32), atol=0.02)
    finally:
        server.shutdown()


def test_clients_and_hosts_cross(served, tiny, tmp_path):
    """The wire is the JAX host's: the JAX ServeClient scores against the
    port's host, and the port's client against the JAX host serving the
    JAX bundle of the same params; the scores agree within 1e-5."""
    client, server = served
    jm, params, _ = tiny
    jax_export_scorer(jm, params, str(tmp_path), stages=("pair", "encode", "kv"))
    jax_server = JaxBundleServer(jax_load_scorer(str(tmp_path)), max_wait_ms=5.0)
    jax_server.start()
    try:
        x = np.random.default_rng(6).normal(size=(2, 2, 32, 32, 3)).astype(np.float32)
        jax_on_port = JaxServeClient(server.url).score(x)
        port_on_jax = ServeClient(jax_server.url).score(x)
        np.testing.assert_allclose(jax_on_port, port_on_jax, atol=1e-5)
        np.testing.assert_allclose(jax_on_port, client.score(x), atol=0)
        # the staged stages, too: each host's kv of each host's features
        jax_client, port_client = JaxServeClient(server.url), ServeClient(jax_server.url)
        kv_port = jax_client.stage("kv", jax_client.stage("encode", x[:, 0]))
        kv_jax = port_client.stage("kv", port_client.stage("encode", x[:, 0]))
        assert kv_port.shape == kv_jax.shape == (2, 2, 4, 256)
        np.testing.assert_allclose(kv_port, kv_jax, atol=1e-5)
    finally:
        jax_server.shutdown()


def test_server_cli_end_to_end(bundle, tiny):
    """python -m vit_ed_tpu_torch.serve --bundle DIR --device cpu serves the
    bundle on a free port; a client in this process scores against it."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "vit_ed_tpu_torch.serve", "--bundle", str(bundle),
         "--port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        line = proc.stdout.readline()
        assert "serving" in line, line
        client = ServeClient(line.strip().rsplit(" on ", 1)[1], timeout=60)
        assert client.health() == {"ok": True}
        x = np.random.default_rng(4).normal(size=(2, 2, 32, 32, 3)).astype(np.float32)
        np.testing.assert_allclose(client.score(x), _live(tiny, "pair", x), atol=1e-5)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
