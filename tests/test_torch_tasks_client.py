"""The port's task models, local training and server optimizers against the
reference, starting from the reference's own weights
(``params_from_reference``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.fed import client as ref_client  # noqa: E402
from repro.fed import tasks as ref_tasks  # noqa: E402
from repro.optim import fedopt as ref_fedopt  # noqa: E402
from repro_torch.fed import client, tasks  # noqa: E402
from repro_torch.optim import fedopt  # noqa: E402

# f32 forward/backward through a few matmuls, summed in another order.
TOL = dict(rtol=1e-5, atol=1e-6)


def _case(name):
    rng = np.random.default_rng(7)
    if name == "logreg":
        args = dict(dim=12, n_classes=5)
        x = rng.standard_normal((3, 16, 12)).astype(np.float32)
        y = rng.integers(0, 5, (3, 16)).astype(np.int32)
    elif name == "mlp":
        args = dict(dim=12, n_classes=5, hidden=16, depth=2)
        x = rng.standard_normal((3, 16, 12)).astype(np.float32)
        y = rng.integers(0, 5, (3, 16)).astype(np.int32)
    else:
        args = dict(vocab=32, d_model=24, n_layers=2, n_heads=3)
        x = rng.integers(0, 32, (3, 4, 10)).astype(np.int32)
        y = np.roll(x, -1, axis=-1)
    factory = {"logreg": "logistic_regression", "mlp": "mlp_classifier", "tiny_lm": "tiny_lm"}[name]
    ref_task = getattr(ref_tasks, factory)(**args)
    task = getattr(tasks, factory)(**args)
    ref_params = ref_task.init(jax.random.PRNGKey(3))
    params = tasks.params_from_reference(jax.tree_util.tree_map(np.asarray, ref_params))
    return ref_task, task, ref_params, params, x, y


def _close(got, want, **tol):
    g, w = tasks.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("name", ["logreg", "mlp", "tiny_lm"])
def test_loss_grad_and_accuracy_match(name):
    ref_task, task, ref_params, params, x, y = _case(name)
    batch_r, batch_p = (jnp.asarray(x[0]), jnp.asarray(y[0])), (torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    loss_r, grad_r = jax.value_and_grad(ref_task.loss)(ref_params, batch_r)
    grad_p, loss_p = torch.func.grad_and_value(task.loss)(params, batch_p)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-6)
    _close(grad_p, grad_r, rtol=1e-4, atol=1e-6)
    assert float(task.accuracy(params, batch_p)) == float(ref_task.accuracy(ref_params, batch_r))


def test_params_keep_reference_names_and_layout():
    _, task, ref_params, params, _, _ = _case("tiny_lm")
    assert sorted(params) == sorted(ref_params) == ["blk0", "blk1", "emb"]
    assert sorted(params["blk0"]) == ["down", "proj", "qkv", "up"]
    assert params["blk0"]["qkv"].shape == (24, 72)  # (in, out)
    fresh = task.init(torch.Generator().manual_seed(0), "cpu")
    assert [tuple(t.shape) for t in tasks.tree_leaves(fresh)] == [
        a.shape for a in jax.tree_util.tree_leaves(ref_params)
    ]


@pytest.mark.parametrize("name", ["logreg", "mlp", "tiny_lm"])
def test_local_update_matches(name):
    ref_task, task, ref_params, params, x, y = _case(name)
    lr = 0.3
    delta_r, loss_r = ref_client.local_update(ref_params, ref_task.loss, (jnp.asarray(x), jnp.asarray(y)), lr)
    delta_p, loss_p = client.local_update(params, task.loss, (torch.from_numpy(x), torch.from_numpy(y)), lr)
    np.testing.assert_allclose(float(loss_p), float(loss_r), rtol=1e-5)
    _close(delta_p, delta_r, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(
        float(client.update_norm(delta_p)), float(ref_client.update_norm(delta_r)), rtol=1e-5
    )


def test_vmapped_local_update_equals_per_client():
    """The server vmaps local_update over clients; each row equals the
    client's own call."""
    _, task, _, params, x, y = _case("tiny_lm")
    xs = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    ys = torch.from_numpy(np.stack([y, y[::-1].copy()]))

    def one(p, xb, yb):
        d, loss = client.local_update(p, task.loss, (xb, yb), 0.1)
        return d, loss, client.update_norm(d)

    deltas, losses, norms = torch.func.vmap(one, in_dims=(None, 0, 0))(params, xs, ys)
    for i in range(2):
        d_i, l_i, n_i = one(params, xs[i], ys[i])
        torch.testing.assert_close(losses[i], l_i, rtol=1e-6, atol=0)
        torch.testing.assert_close(norms[i], n_i, rtol=1e-5, atol=0)
        _close(tasks.tree_map(lambda t: t[i], deltas), tasks.tree_map(lambda t: t.numpy(), d_i), **TOL)


@pytest.mark.parametrize("opt", ["fedavg", "fedadam"])
def test_server_optimizers_match(opt):
    _, _, ref_params, params, _, _ = _case("mlp")
    rng = np.random.default_rng(1)
    ref_opt = ref_fedopt.FedAvgServer(lr=0.7) if opt == "fedavg" else ref_fedopt.FedAdam(lr=0.1)
    pt_opt = fedopt.FedAvgServer(lr=0.7) if opt == "fedavg" else fedopt.FedAdam(lr=0.1)
    st_r, st_p = ref_opt.init(ref_params), pt_opt.init(params)
    for _ in range(3):
        est = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), ref_params
        )
        ref_params, st_r = ref_opt.apply(ref_params, jax.tree_util.tree_map(jnp.asarray, est), st_r)
        params, st_p = pt_opt.apply(params, tasks.params_from_reference(est), st_p)
    _close(params, ref_params, **TOL)
