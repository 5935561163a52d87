"""Card-only checks of the port: the CUDA kernel and the entry points on
``cuda``.  Every test is marked ``cuda`` and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are the JAX suite's fused-vs-scanned bounds
(tests/test_fused_train.py): losses rtol 2e-4 / atol 1e-6, params
rtol 5e-3 / atol 2e-5; resume continuity rtol 1e-4 / atol 1e-7.
"""

import numpy as np
import pytest
import torch

from iotml_torch.data.dataset import Batch
from iotml_torch.models.autoencoder import (CAR_AUTOENCODER, PARAM_NAMES,
                                            AutoencoderSpec)
from iotml_torch.ops import fused_train
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.train.loop import Trainer, TrainState
from iotml_torch.train.optim import Adam

LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-3, atol=2e-5)
RESUME_TOL = dict(rtol=1e-4, atol=1e-7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _data(S, B, F, seed):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, 1, (S, B, F)).astype(np.float32)
    xs[:, :, ::5] = 0.0
    masks = np.ones((S, B), np.float32)
    masks[-1, B // 2:] = 0.0
    xs[-1, B // 2:] = 0.0
    masks *= rng.uniform(0.25, 1.0, masks.shape).astype(np.float32)
    return xs, masks


def _state(F, device, encoding_dim=14, seed=0):
    spec = AutoencoderSpec(input_dim=F, encoding_dim=encoding_dim)
    return TrainState.create(
        spec.build(device, torch.Generator().manual_seed(seed)), Adam())


def _launches():
    return (fused_train.fused_fit.launches,
            dict(fused_train.fused_fit.launches_by_design))


def _assert_matches_plain(kernel_out, plain_out, steps):
    (k_state, k_loss, k_acc), (p_state, p_loss, p_acc) = kernel_out, plain_out
    torch.testing.assert_close(k_loss, p_loss, **LOSS_TOL)
    torch.testing.assert_close(k_acc, p_acc, **LOSS_TOL)
    for k in PARAM_NAMES:
        torch.testing.assert_close(k_state.params[k], p_state.params[k],
                                   **PARAM_TOL)
        torch.testing.assert_close(k_state.opt_state.mu[k],
                                   p_state.opt_state.mu[k], **PARAM_TOL)
        torch.testing.assert_close(k_state.opt_state.nu[k],
                                   p_state.opt_state.nu[k], **PARAM_TOL)
    assert k_state.opt_state.count == steps


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 100, 128, 256])
@pytest.mark.parametrize("design", ["rows", "elements"])
@pytest.mark.parametrize("F", [18, 30])
def test_kernel_matches_plain_version(F, design, B, cuda_device):
    """Both designs at the batch sizes the rows design takes, fractional
    masks and a ragged last batch (at B = 1 the last batch is all
    masked: denominator 1)."""
    xs, masks = _data(6, B, F, seed=F + B)
    x_d = torch.from_numpy(xs).to(cuda_device)
    m_d = torch.from_numpy(masks).to(cuda_device)
    st = _state(F, cuda_device, seed=B)
    total, by_design = _launches()
    kernel_out = fused_train.fused_fit(st, x_d, m_d, 4, design=design)
    torch.cuda.synchronize()
    assert fused_train.fused_fit.launches == total + 1
    assert fused_train.fused_fit.launches_by_design[design] == \
        by_design[design] + 1
    plain_out = fused_train.fused_fit_reference(st, x_d, m_d, 4)
    _assert_matches_plain(kernel_out, plain_out, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [18, 30])
def test_rows_design_repeats_bit_for_bit_and_resumes(F, cuda_device):
    xs, masks = _data(6, 100, F, seed=F)
    x_d = torch.from_numpy(xs).to(cuda_device)
    m_d = torch.from_numpy(masks).to(cuda_device)
    st = _state(F, cuda_device)
    assert fused_train.fit_design(100, F, 14, 7) == "rows"
    once, l_once, a_once = fused_train.fused_fit(st, x_d, m_d, 4)
    again, l_again, a_again = fused_train.fused_fit(st, x_d, m_d, 4)
    assert torch.equal(l_once, l_again) and torch.equal(a_once, a_again)
    for tree in ("params", "mu", "nu"):
        a = once.params if tree == "params" else getattr(once.opt_state, tree)
        b = again.params if tree == "params" \
            else getattr(again.opt_state, tree)
        for k in PARAM_NAMES:
            assert torch.equal(a[k], b[k]), (tree, k)
    half, l_a, _ = fused_train.fused_fit(st, x_d, m_d, 2)
    twice, l_b, _ = fused_train.fused_fit(half, x_d, m_d, 2)
    torch.testing.assert_close(torch.cat([l_a, l_b]), l_once, **RESUME_TOL)
    assert twice.opt_state.count == once.opt_state.count == 24
    for k in PARAM_NAMES:
        torch.testing.assert_close(twice.params[k], once.params[k],
                                   rtol=1e-3, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B, encoding_dim", [(300, 14), (100, 16)])
def test_other_shapes_take_the_elements_design(B, encoding_dim,
                                               cuda_device):
    """A batch over 256 rows, or a width the rows design is not built
    for, launches the elements design on its own."""
    xs, masks = _data(3, B, 18, seed=B)
    x_d = torch.from_numpy(xs).to(cuda_device)
    m_d = torch.from_numpy(masks).to(cuda_device)
    st = _state(18, cuda_device, encoding_dim=encoding_dim)
    assert fused_train.fit_design(B, 18, encoding_dim, 7) == "elements"
    total, by_design = _launches()
    kernel_out = fused_train.fused_fit(st, x_d, m_d, 2)
    torch.cuda.synchronize()
    assert fused_train.fused_fit.launches_by_design == {
        **by_design, "elements": by_design["elements"] + 1}
    _assert_matches_plain(kernel_out,
                          fused_train.fused_fit_reference(st, x_d, m_d, 2), 6)
    with pytest.raises(ValueError, match="rows design does not take"):
        fused_train.fused_fit(st, x_d, m_d, 2, design="rows")
    assert fused_train.fused_fit.launches == total + 1


@pytest.mark.cuda
def test_library_design_rule_matches_fit_design(cuda_device):
    """The library's own rule (``iotml_fused_fit_design``) and
    ``fit_design`` agree on every shape around the rows design's edges."""
    lib = fused_train._library()
    for B in (1, 31, 100, 128, 129, 200, 256, 257, 300):
        for F, E, H in ((18, 14, 7), (30, 14, 7), (18, 16, 7), (18, 14, 8),
                        (12, 14, 7)):
            assert fused_train.DESIGNS[lib.iotml_fused_fit_design(
                B, F, E, H)] == fused_train.fit_design(B, F, E, H), \
                (B, F, E, H)


@pytest.mark.cuda
def test_kernel_rejects_a_step_over_shared_memory(cuda_device):
    st = TrainState.create(CAR_AUTOENCODER.build(cuda_device), Adam())
    # elements: params, mu, nu; batch and mask; four [B, 14|7] activations
    # and three deltas, the output/dz4 buffer; per-warp reduction scratch
    need, optin = fused_train.smem(st.params, 300, cuda_device)
    assert need == 4 * (3 * 571 + 300 * (2 * 18 + 2 * 14 + 4 * 7) + 300
                        + 32 * 4)
    assert need <= optin
    # rows: params, mu, nu as [out][in + 1 padded to 4] (592 floats); per
    # row x|1 twice (this step's, the next), h1|1, h2|1, h3|1, dz1..dz4 at
    # strides of an odd count of float4s (2 x 20 + 20 + 12 + 12 + 20 + 12
    # + 12 + 20); 3 metric sums for each of the block's 256 threads
    need, optin = fused_train.smem(st.params, 100, cuda_device)
    assert need == 4 * (3 * 592 + 100 * 148 + 3 * 256)
    assert need == fused_train.smem(st.params, 100, cuda_device,
                                    design="rows")[0]
    assert need <= optin
    # its largest: creditcard (F = 30, 856 padded parameters, 196 floats a
    # row: 2 x 36 + 20 + 12 + 12 + 20 + 12 + 12 + 36) at B = 256
    wide = TrainState.create(AutoencoderSpec(input_dim=30).build(cuda_device),
                             Adam())
    need, optin = fused_train.smem(wide.params, 256, cuda_device)
    assert need == 4 * (3 * 856 + 256 * 196 + 3 * 256)
    assert need <= optin
    assert fused_train.fits(st.params, 100, cuda_device)
    assert not fused_train.fits(st.params, 2000, cuda_device)
    xs = torch.zeros((1, 2000, 18), device=cuda_device)
    masks = torch.ones((1, 2000), device=cuda_device)
    before = fused_train.fused_fit.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_train.fused_fit(st, xs, masks, 1)
    assert fused_train.fused_fit.launches == before


@pytest.mark.cuda
def test_fit_compiled_on_the_card(cuda_device):
    """No device given: the card.  auto launches the kernel once and
    agrees with the autograd step loop."""
    xs, masks = _data(5, 64, 18, seed=1)
    bs = [Batch(x=xs[i], n_valid=int((masks[i] > 0).sum()), first_index=i)
          for i in range(5)]
    before = fused_train.fused_fit.launches
    rows = fused_train.fused_fit.launches_by_design["rows"]
    auto = Trainer(CAR_AUTOENCODER)
    h_auto = auto.fit_compiled(bs, epochs=3)
    assert fused_train.fused_fit.launches == before + 1
    assert fused_train.fused_fit.launches_by_design["rows"] == rows + 1
    assert auto.state.params["encoder0.weight"].is_cuda
    h_never = Trainer(CAR_AUTOENCODER).fit_compiled(bs, epochs=3,
                                                     fused="never")
    np.testing.assert_allclose(h_auto["loss"], h_never["loss"], **LOSS_TOL)


@pytest.mark.cuda
def test_scorer_on_the_card_matches_the_cpu(cuda_device):
    from iotml_torch.data.dataset import RowSource, SensorBatches
    from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
    from iotml_torch.stream.producer import OutputSequence

    src = RowSource.from_fleet(
        FleetGenerator(FleetScenario(num_cars=50, failure_rate=0.2)), 10)
    params = CAR_AUTOENCODER.build("cpu").state_dict()
    runs = []
    for device in (None, "cpu"):
        out = OutputSequence()
        sc = StreamScorer(CAR_AUTOENCODER, params,
                          SensorBatches(src, batch_size=100), out,
                          threshold=0.5, device=device)
        assert sc.score_available() == 500
        runs.append(out.published)
    for (i, a), (j, b) in zip(*runs):
        assert i == j
        va, ta = a.decode().split("|", 1)
        vb, tb = b.decode().split("|", 1)
        np.testing.assert_allclose(
            np.array(va.strip("[]").split(), float),
            np.array(vb.strip("[]").split(), float), rtol=0, atol=1e-6)
