"""The port's data generators equal the reference's bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import partition as ref_partition  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro_torch.data import partition, pipeline  # noqa: E402


@pytest.mark.parametrize("n,total,alpha,seed", [(10, 200, 1.5, 0), (37, 5000, 2.2, 4), (100, 20000, 2.0, 0)])
def test_power_law_sizes_equal(n, total, alpha, seed):
    want = ref_partition.power_law_sizes(n, total, alpha=alpha, seed=seed)
    got = partition.power_law_sizes(n, total, alpha=alpha, seed=seed)
    np.testing.assert_array_equal(got, want)
    for frac in (0.1, 0.5):
        assert partition.size_share(got, frac) == ref_partition.size_share(want, frac)


def _assert_dataset_equal(got, want):
    for name in ("features", "labels", "sizes"):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    np.testing.assert_array_equal(got.lam.numpy(), np.asarray(want.lam))


@pytest.mark.parametrize(
    "kw", [dict(n_clients=12, total=600, power=2.0, seed=3), dict(n_clients=5, dim=7, n_classes=3, total=90)]
)
def test_synthetic_classification_bitwise(kw):
    _assert_dataset_equal(
        pipeline.synthetic_classification(**kw, device="cpu"),
        ref_pipeline.synthetic_classification(**kw),
    )


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_clients=8, seq_len=16, vocab=64, total_seqs=200, power=2.2, seed=0),
        dict(n_clients=5, seq_len=9, vocab=31, total_seqs=80, n_styles=3, seed=2),
    ],
)
def test_synthetic_tokens_bitwise(kw):
    _assert_dataset_equal(
        pipeline.synthetic_tokens(**kw, device="cpu"), ref_pipeline.synthetic_tokens(**kw)
    )


def test_client_batch_with_injected_indices():
    """client_batch at the indices jax.random.randint draws reproduces the
    reference's batch; gather stacks several clients' batches."""
    kw = dict(n_clients=6, total=300, power=2.0, seed=1)
    ref = ref_pipeline.synthetic_classification(**kw)
    ds = pipeline.synthetic_classification(**kw, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    idx = np.stack(
        [np.asarray(jax.random.randint(keys[i], (7,), 0, ref.sizes[i])) for i in range(6)]
    )
    for i in range(6):
        x_want, y_want = ref.client_batch(i, keys[i], 7)
        x, y = ds.client_batch(i, torch.from_numpy(idx[i]).long())
        np.testing.assert_array_equal(x.numpy(), np.asarray(x_want))
        np.testing.assert_array_equal(y.numpy(), np.asarray(y_want))
    ids = torch.tensor([4, 0])
    xs, ys = ds.gather(ids, torch.from_numpy(idx[[4, 0]][:, None]).long())
    assert xs.shape == (2, 1, 7, 60) and ys.shape == (2, 1, 7)
    np.testing.assert_array_equal(xs[0, 0].numpy(), np.asarray(ref.client_batch(4, keys[4], 7)[0]))


def test_generators_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.synthetic_tokens(2, 4, 8, 16)
