"""The rest of training on a card: the sparse Wide&Deep step against the
dense recsys step, and a resumed ``fit`` against an uninterrupted one
at sst2-bert's shapes (BERT-base widths, 2 layers, flash attention:
B5-B7 on the tensor cores).

Needs an NVIDIA card with ``nvcc`` and skips without one; imports no
JAX::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_training.py -q

Tolerances: the sparse step within 1e-5 of the dense one (float32),
untouched rows bit-equal (duplicate-id sums use atomics on the card, so touched
rows are not bitwise reproducible). The resumed run: losses within 2e-3
of the uninterrupted run's, every AdamW moment within 2e-2 relative L2
(bf16 compute; a run whose moments were not restored is far outside
it), the key projection's bias (no gradient, only rounding noise) left
out.
"""

import numpy as np
import pytest
import torch

from mlapi_tpu_torch.datasets import get_dataset
from mlapi_tpu_torch.models import get_model
from mlapi_tpu_torch.ops import cuda as kern
from mlapi_tpu_torch.train import fit
from mlapi_tpu_torch.train.optimizers import state_tensors

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash kernels have no CPU mode)")
    return torch.device("cuda")


class _Splits:
    def __init__(self, n=2048, used=500, seed=0):
        rng = np.random.default_rng(seed)
        self.x_train = np.concatenate(
            [rng.normal(size=(n, 13)).astype(np.float32),
             rng.integers(0, used, (n, 26)).astype(np.float32)], axis=1)
        self.y_train = rng.integers(0, 2, n).astype(np.int32)
        self.x_test = self.x_train[:256]
        self.y_test = self.y_train[:256]
        self.extras = {}


def test_sparse_step_matches_dense_on_the_card(card):
    # float32 hidden layers: a last-bit difference in a duplicate-id sum
    # must not flip a bf16 rounding of the MLP's input.
    cfg = dict(num_dense=13, vocab_sizes=[1000] * 26, embed_dim=16,
               hidden_dims=[256, 128], num_classes=2,
               compute_dtype="float32")
    kw = dict(steps=20, batch_size=512, learning_rate=1e-3, seed=1)
    dense = get_model("wide_deep", **cfg, seed=0, device=card)
    sparse = get_model("wide_deep", **cfg, seed=0, device=card)
    init = {k: v.clone() for k, v in dense.state_dict().items()}
    fit(dense, _Splits(), optimizer="recsys-adamw", **kw)
    fit(sparse, _Splits(), optimizer="recsys-sparse-adamw", **kw)
    for key, p in sparse.state_dict().items():
        q = dense.state_dict()[key]
        assert float((p - q).abs().max()) <= 1e-5, key
        if key.endswith("_tables"):
            # Ids 500.. are never drawn.
            assert torch.equal(p[:, 500:], init[key][:, 500:]), key
            assert torch.equal(q[:, 500:], init[key][:, 500:]), key


def test_resumed_fit_matches_uninterrupted_on_sst2_bert_shapes(card,
                                                               tmp_path):
    """7 steps saving every 2, against 3 steps, a stop and a rerun to 7:
    the step-6 train states (params and AdamW moments) and the losses of
    steps 3-7 agree."""
    from mlapi_tpu_torch.checkpoint import load_checkpoint, load_opt_state

    splits = get_dataset("sst2")
    # BERT-base's widths (the constructor's defaults) at 2 layers.
    cfg = dict(num_classes=2, num_layers=2, attention_impl="flash")
    kw = dict(batch_size=32, learning_rate=2e-5, optimizer="adamw", seed=0,
              save_every=2)

    def model():
        return get_model("bert_classifier", **cfg, seed=0, device=card)

    full = fit(model(), splits, steps=7, checkpoint_dir=str(tmp_path / "a"),
               **kw)
    fit(model(), splits, steps=3, checkpoint_dir=str(tmp_path / "b"), **kw)
    b5, b6 = kern.flash_forward.launches, kern.flash_backward_dq.launches
    resumed = fit(model(), splits, steps=7,
                  checkpoint_dir=str(tmp_path / "b"), **kw)
    assert resumed.start_step == 2
    # Steps 3-7 and the test evaluation, one launch a layer each.
    evals = -(-len(splits.x_test) // 4096)
    assert kern.flash_forward.launches - b5 == 2 * (5 + evals)
    assert kern.flash_backward_dq.launches - b6 == 2 * 5
    np.testing.assert_allclose(resumed.step_losses, full.step_losses[2:],
                               atol=2e-3, rtol=0)
    # Softmax is invariant to a shift of a query's scores, so the key
    # projection's bias gets no gradient: both runs step it by rounding
    # noise, which Adam scales up to the rate. Its leaves are left out.
    def live(key):          # a parameter's name or a moment's path
        return not key.replace("/", ".").endswith(".k.bias")

    want, _ = load_checkpoint(tmp_path / "a" / "step_00000006")
    got, _ = load_checkpoint(tmp_path / "b" / "step_00000006")
    # Steps 3-6 apart at most: Adam's step is at most ~3.2 rates early on.
    for key in filter(live, want):
        gap = float((got[key] - want[key]).abs().max())
        assert gap <= 4 * 3.2 * kw["learning_rate"], (key, gap)
    want = load_opt_state(tmp_path / "a" / "step_00000006")
    got = load_opt_state(tmp_path / "b" / "step_00000006")
    assert set(got) == set(want) and int(got["count"]) == 6
    for key in filter(live, want):
        w = want[key]
        err = np.linalg.norm(got[key] - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 2e-2, (key, err)


def test_moments_survive_a_round_trip_on_the_card(card, tmp_path):
    """The train state restores every AdamW moment exactly (no rounding
    through the npz file) on the card."""
    from mlapi_tpu_torch.train.loop import _make_optimizer
    from mlapi_tpu_torch.train.optimizers import state_from_flat, state_to_flat

    m = get_model("mlp", num_features=64, num_classes=10, hidden_dims=[32],
                  seed=0, device=card)
    named = dict(m.named_parameters())
    opt = _make_optimizer("adamw", 1e-3, named.values())
    for p in named.values():
        p.grad = torch.randn_like(p)
    opt.step()
    names = {p: n for n, p in named.items()}
    flat = state_to_flat(opt, names)
    opt2 = _make_optimizer("adamw", 1e-3, named.values())
    state_from_flat(opt2, names, flat)
    for (k, a), (_, b) in zip(state_tensors(opt, names),
                              state_tensors(opt2, names)):
        assert b.device == a.device and torch.equal(a, b), k
