"""The port's expert banks (vit_ed_tpu_torch/models/moe.py) against the JAX
``MoeMlp`` on the CPU, one device (the expert-parallel half of
tests/test_moe.py waits for several cards): the same seeded numpy inputs
and the JAX params carried across.

Tolerances: float32 outputs and aux terms within 1e-5 (absolute; rtol
1e-5 for the aux scalars), bfloat16 outputs within 2e-2 of the output's
max (one bf16 ulp is 2^-8 of a value; the bank's einsums accumulate in
different orders). Routing, capacity drops and ties are compared exactly:
a dropped token's output is exactly zero on both sides.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ed_tpu.models.moe import MoeMlp as JaxMoeMlp
from vit_ed_tpu.models.moe import collect_moe_aux as jax_collect_moe_aux
from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from vit_ed_tpu_torch.models.moe import MoeMlp, collect_moe_aux
from vit_ed_tpu_torch.models.vit_ed import ViTED
from vit_ed_tpu_torch.train.checkpoint import load_pretrained

E, D, HID = 4, 8, 16
VKW = dict(img_size=32, patch_size=16, num_classes=4, embed_dim=64, depth=2,
           c_depth=1, num_heads=2)


def _pair(b, t, seed, **kw):
    """A JAX MoeMlp, its params, the port's bank on them and x [b, t, D]."""
    jm = JaxMoeMlp(hidden_dim=HID, out_dim=D, num_experts=E, **kw)
    x = np.random.default_rng(seed).normal(size=(b, t, D)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    port = MoeMlp(D, HID, E, capacity_factor=kw.get("capacity_factor", 1.25),
                  route_k=kw.get("route_k", 1), jitter=kw.get("jitter", 0.0))
    _load(port, params)
    return jm, params, port.eval(), x


def _load(port, params):
    sd = {"router.weight": torch.tensor(params["router"]["kernel"].T.copy())}
    sd.update({k: torch.tensor(params[k]) for k in ("w1", "b1", "w2", "b2")})
    port.load_state_dict(sd, strict=True)


def _jax(jm, params, x, **kw):
    out, mut = jm.apply({"params": params}, jnp.asarray(x), mutable=["moe_aux"], **kw)
    return np.asarray(out, np.float32), mut


def _ours(port, x, dtype=torch.float32):
    with torch.no_grad():
        y, aux = port(torch.from_numpy(np.array(x)).to(dtype))
    return y.float().numpy(), aux.numpy()


@pytest.mark.parametrize("route_k,capacity", [(1, 4.0), (2, 8.0), (2, 1.25)])
def test_moe_routing_matches_jax_f32(route_k, capacity):
    jm, params, port, x = _pair(2, 12, route_k, capacity_factor=capacity,
                                route_k=route_k)
    ref, mut = _jax(jm, params, x)
    got, aux = _ours(port, x)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux, [float(mut["moe_aux"]["load_balance"][0]),
                                     float(mut["moe_aux"]["router_z"][0])], rtol=1e-5)


@pytest.mark.parametrize("route_k", [1, 2])
def test_moe_routing_matches_jax_bf16(route_k):
    jm = JaxMoeMlp(hidden_dim=HID, out_dim=D, num_experts=E, route_k=route_k,
                   capacity_factor=2.0, dtype=jnp.bfloat16)
    x = np.random.default_rng(7).normal(size=(2, 12, D)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x))["params"])
    port = MoeMlp(D, HID, E, capacity_factor=2.0, route_k=route_k).eval()
    _load(port, params)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ref, _ = _jax(jm, params, jnp.asarray(xb, jnp.bfloat16))
    got, _ = _ours(port, xb, torch.bfloat16)
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()


def test_moe_aux_terms_and_weighted_sum_match_jax():
    jm, params, port, x = _pair(2, 6, 4)
    _, mut = _jax(jm, params, x)
    _, aux = _ours(port, x)
    aux = torch.from_numpy(np.stack([aux, aux * 0.5]))      # two banks
    ref_mut = {"moe_aux": {"a": jax.tree.map(lambda v: v, mut["moe_aux"]),
                           "b": jax.tree.map(lambda v: v * 0.5, mut["moe_aux"])}}
    for w, z in ((0.01, 0.001), (0.01, 0.0), (1.0, 1.0)):
        np.testing.assert_allclose(float(collect_moe_aux(aux, w, z)),
                                   float(jax_collect_moe_aux(ref_mut, w, z)), rtol=1e-5)
    assert float(collect_moe_aux(torch.zeros(0, 2), 0.01, 0.001)) == 0.0


def test_moe_eval_is_batch_independent():
    """Capacity is per sample: a sample's routing is the same alone and in
    a batch, exactly; its output within 1e-6 (torch's CPU einsums round
    differently at another batch size, where XLA's gave equal bits)."""
    _, _, port, x = _pair(4, 12, 6, capacity_factor=0.5)
    full, _ = _ours(port, x)
    dispatch, combine, _ = port.route(torch.from_numpy(x))
    for i in range(4):
        solo, _ = _ours(port, x[i:i + 1])
        d1, c1, _ = port.route(torch.from_numpy(x[i:i + 1]))
        assert torch.equal(d1[0], dispatch[i]) and torch.equal(c1[0], combine[i])
        np.testing.assert_allclose(full[i], solo[0], atol=1e-6, rtol=0)


def test_moe_capacity_drops_match_jax():
    """C = 1 (top-1) drops every later token of an expert; with top-2 at
    C = ceil(10 / 4 * 0.5) = 2 the second choices land past capacity
    (position >= C), where jax.nn.one_hot gives a zero row."""
    jm, params, port, x = _pair(1, 10, 1, capacity_factor=0.4)
    assert port.capacity(10) == 1
    ref, _ = _jax(jm, params, x)
    got, _ = _ours(port, x)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    top = np.argmax(x[0] @ params["router"]["kernel"], -1)
    seen = set()
    for ti, ei in enumerate(top):
        assert (np.abs(got[0, ti]).max() == 0) == (ei in seen)
        seen.add(int(ei))

    jm, params, port, x = _pair(1, 10, 3, capacity_factor=0.5, route_k=2)
    dispatch, _, _ = port.route(torch.from_numpy(x))
    oh = torch.nn.functional.one_hot(
        torch.sort(port.router(torch.from_numpy(x)).softmax(-1), dim=-1,
                   descending=True, stable=True)[1][..., :2], E).float()
    routed = oh.sum((1, 2))[0]                                # [E] choices per expert
    assert port.capacity(10) == 2 and routed.max() > 2        # some overflow
    assert torch.equal(dispatch.sum((1, 3))[0], routed.clamp(max=2))
    ref, _ = _jax(jm, params, x)
    np.testing.assert_allclose(_ours(port, x)[0], ref, atol=1e-5, rtol=0)


def test_moe_tied_router_takes_lower_index():
    """A zero router ties every expert: jax.lax.top_k takes the lower
    indices first, so every token goes to expert 0 (and 1 with top-2)."""
    for k in (1, 2):
        jm, params, port, x = _pair(2, 6, 5, capacity_factor=4.0, route_k=k)
        params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
        _load(port, params)
        dispatch, combine, _ = port.route(torch.from_numpy(x))
        per_expert = dispatch.sum((0, 1, 3))
        assert per_expert.tolist() == ([12.0, 0, 0, 0] if k == 1 else [12.0, 12.0, 0, 0])
        ref, _ = _jax(jm, params, x)
        np.testing.assert_allclose(_ours(port, x)[0], ref, atol=1e-5, rtol=0)


def test_moe_jitter_train_only():
    """Eval ignores the jitter; training draws it from the model-owned
    generator (one seed, the same draw) and raises without one."""
    _, params, port, x = _pair(2, 16, 5, jitter=0.5)
    base = MoeMlp(D, HID, E)
    _load(base, params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        assert torch.equal(port.eval()(xt)[0], base.eval()(xt)[0])
        port.train()
        with pytest.raises(RuntimeError, match="seeded generator"):
            port(xt)
        port.generator = torch.Generator().manual_seed(1)
        t1 = port(xt)[0]
        port.generator.manual_seed(1)
        assert torch.equal(port(xt)[0], t1)
        t2 = port(xt)[0]
    assert (t1 - t2).abs().max() > 0
    # the model's seed_drop_path hands the bank its generator
    model = ViTED(**VKW, moe_experts=4, moe_interval=1, moe_jitter=0.1)
    gen = model.seed_drop_path(3)
    assert all(b.mlp.generator is gen for b in model.blocks)


@pytest.fixture(scope="module")
def moe_vited():
    """A JAX ViTED with a bank in every encoder block, and the port's on
    its converted params (head_dim 32: the 4-D route)."""
    jm = JaxViTED(**VKW, use_pallas=False, moe_experts=4, moe_interval=1,
                  moe_capacity=1.5, moe_route_k=2)
    x = np.random.default_rng(3).normal(size=(3, 2, 32, 32, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                       jnp.asarray(x[:1]))["params"])
    model = load_jax_params(ViTED(**VKW, moe_experts=4, moe_interval=1,
                                  moe_capacity=1.5, moe_route_k=2), params)
    return jm, params, model, x


def test_moe_vited_matches_jax_and_split_forward(moe_vited):
    jm, params, model, x = moe_vited
    assert set(jax_params_to_state_dict(params)) == set(model.state_dict())
    ref, mut = jax.jit(lambda p, a: jm.apply({"params": p}, a, mutable=["moe_aux"]))(
        params, jnp.asarray(x))
    with torch.no_grad():
        out, aux = model.eval()(torch.from_numpy(x), with_aux=True)
        feats = model.encode(torch.from_numpy(x[:, 0]))
        split = model(feats, torch.from_numpy(x[:, 1]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(split.numpy(), out.numpy())
    want = np.asarray([[float(v["mlp"]["load_balance"][0]),
                        float(v["mlp"]["router_z"][0])]
                       for _, v in sorted(mut["moe_aux"].items())])
    np.testing.assert_allclose(aux.numpy(), want, rtol=1e-5)


def test_moe_checkpointed_forward_matches_plain(moe_vited):
    """TRAIN.USE_CHECKPOINT recomputes every block in the backward: the
    aux terms, values of the forward, are counted once and the gradients
    equal the plain run's (the JAX test_moe_under_remat_matches_unremat)."""
    _, params, _, x = moe_vited
    outs = {}
    for remat in (False, True):
        model = load_jax_params(ViTED(**VKW, moe_experts=4, moe_interval=1,
                                      moe_capacity=1.5, moe_route_k=2, moe_jitter=0.1,
                                      drop_path_rate=0.1, use_checkpoint=remat), params)
        model.train().seed_drop_path(5)
        lg, aux = model(torch.from_numpy(x), with_aux=True)
        loss = (lg.float() ** 2).sum() + collect_moe_aux(aux, 0.01, 0.001)
        loss.backward()
        outs[remat] = (float(loss.detach()), aux.detach().clone(),
                       {k: p.grad.clone() for k, p in model.named_parameters()})
    assert outs[False][0] == outs[True][0]
    assert torch.equal(outs[False][1], outs[True][1])
    for k, g in outs[False][2].items():
        torch.testing.assert_close(outs[True][2][k], g, atol=1e-6, rtol=1e-6)


def test_dense_checkpoint_upcycles_like_jax(tmp_path, caplog):
    """A dense checkpoint into a MoE model: every expert from its block's
    fc1 / fc2 (the JAX _upcycle_moe on the same trees), the routers keep
    their init, the dense blocks ride along; a bank whose shapes differ is
    skipped with the JAX warning."""
    from vit_ed_tpu.train.checkpoint import _merge_params, _upcycle_moe

    kw = dict(VKW, depth=2)
    dense_j = JaxViTED(**kw, use_pallas=False)
    moe_j = JaxViTED(**kw, use_pallas=False, moe_experts=4, moe_interval=2)
    x0 = jnp.zeros((1, 2, 32, 32, 3))
    dense = jax.tree.map(np.asarray, dense_j.init(jax.random.PRNGKey(1), x0)["params"])
    moe = jax.tree.map(np.asarray, moe_j.init(jax.random.PRNGKey(2), x0)["params"])
    merged, _, _ = _merge_params(moe, dense)
    _upcycle_moe(merged, dense, logging.getLogger("jax"))

    torch.save({"model": jax_params_to_state_dict(dense)}, tmp_path / "dense.ckpt")
    model = load_jax_params(ViTED(**kw, moe_experts=4, moe_interval=2), moe)
    router = model.blocks[1].mlp.router.weight.detach().clone()
    logger = logging.getLogger("port_upcycle")
    with caplog.at_level(logging.INFO, logger="port_upcycle"):
        load_pretrained(model, str(tmp_path / "dense.ckpt"), logger)
    assert "Sparse upcycling: initialised 1 expert banks" in caplog.text
    want = jax_params_to_state_dict(merged)
    for k, v in model.state_dict().items():
        if ".mlp.router." in k:
            continue
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    assert torch.equal(model.blocks[1].mlp.router.weight, router)
    fc1 = torch.from_numpy(np.array(dense["blocks_1"]["mlp"]["fc1"]["kernel"]))
    assert all(torch.equal(model.blocks[1].mlp.w1[e], fc1) for e in range(4))

    sd = jax_params_to_state_dict(dense)
    sd["blocks.1.mlp.fc1.weight"] = torch.zeros(512, 64)      # a wider dense MLP
    sd["blocks.1.mlp.fc1.bias"] = torch.zeros(512)
    sd["blocks.1.mlp.fc2.weight"] = torch.zeros(64, 512)
    torch.save(sd, tmp_path / "wide.pth")
    before = model.blocks[1].mlp.w1.detach().clone()
    with caplog.at_level(logging.INFO, logger="port_upcycle"):
        load_pretrained(model, str(tmp_path / "wide.pth"), logger)
    assert "Sparse upcycling skipped for blocks.1" in caplog.text
    assert torch.equal(model.blocks[1].mlp.w1, before)


def test_moe_train_step_loss_matches_jax(moe_vited):
    """The default loss of the port's trainer (criterion + AUX_WEIGHT *
    load balance + Z_WEIGHT * router z) against the JAX train step's loss
    and gradient norm on the same params and batch (f32, 1e-5 relative)."""
    import optax

    from vit_ed_tpu.train.engine import TrainState, make_train_step
    from vit_ed_tpu.train.losses import bce_with_logits as jax_bce
    from vit_ed_tpu_torch.train.engine import Trainer
    from vit_ed_tpu_torch.train.losses import bce_with_logits

    jm, params, model, x = moe_vited
    targets = (np.random.default_rng(9).uniform(size=(3, 4)) > 0.5).astype(np.float32)
    tx = optax.adamw(1e-3)
    state = TrainState(params=params, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    step = make_train_step(jm, tx, jax_bce, 1, moe_aux_weight=0.01, moe_z_weight=0.001)
    _, metrics = step(state, {"samples": jnp.asarray(x[None]),
                              "targets": jnp.asarray(targets[None])},
                      jax.random.PRNGKey(0))

    moe = types.SimpleNamespace(EXPERTS=4, AUX_WEIGHT=0.01, Z_WEIGHT=0.001)
    stub = types.SimpleNamespace(config=types.SimpleNamespace(
        MODEL=types.SimpleNamespace(TYPE="pjs", PJS=types.SimpleNamespace(MOE=moe))))
    stub.add_moe_aux = lambda loss, aux: Trainer.add_moe_aux(stub, loss, aux)
    model.train().seed_drop_path(0)
    model.zero_grad()
    loss = Trainer.make_loss_fn(stub, bce_with_logits)(
        model, {"samples": torch.from_numpy(x), "targets": torch.from_numpy(targets)})
    loss.backward()
    norm = torch.sqrt(sum((p.grad ** 2).sum() for p in model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(norm), float(metrics["grad_norm"]), rtol=1e-4)
    assert stub.moe_aux.shape == (2, 2)           # kept for the Train: line


def test_moe_model_overfits_fixed_batch():
    """Learning signal through the sparse path (the JAX
    test_moe_model_overfits_fixed_batch): router, banks and aux loss fit a
    fixed 4-bin pair batch."""
    from tests.test_learning import _make_direction_pairs
    from vit_ed_tpu_torch.train.losses import bce_with_logits

    torch.manual_seed(0)
    imgs, labels = _make_direction_pairs(np.random.default_rng(0), 64)
    model = ViTED(img_size=32, patch_size=16, num_classes=4, embed_dim=32, depth=1,
                  c_depth=1, num_heads=2, moe_experts=4, moe_interval=1,
                  moe_capacity=2.0).train()
    assert hasattr(model.blocks[0].mlp, "w1")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
    first = None
    for _ in range(300):
        opt.zero_grad()
        loss = 0.0
        for half in (slice(0, 32), slice(32, 64)):
            out, aux = model(x[half], with_aux=True)
            micro = bce_with_logits(out.float(), y[half]) + collect_moe_aux(aux, 0.01)
            (micro / 2).backward()
            loss += float(micro) / 2
        opt.step()
        first = loss if first is None else first
    assert loss < 0.08, f"loss did not converge: {first} -> {loss}"
    with torch.no_grad():
        preds = (model.eval()(x) > 0).float()
    assert (preds == y).all(1).float().mean() >= 0.95
