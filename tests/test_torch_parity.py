"""The port's reference-parity helpers (``dfd_tpu_torch/parity.py``) held
against ``dfd_tpu.parity`` on the CPU.  Both call the same installed torch,
so after the same ``torch.manual_seed`` the initial flats and the
sampler's streams are equal bit for bit; a ``SequentialRunner`` with a
``TorchSampler`` in each package then takes the same actions on the trap
env, ``flat`` within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from dfd_tpu import parity as jparity
from dfd_tpu.models import DiscreteMLP as JDiscreteMLP
from dfd_tpu.models import GaussianMLP as JGaussianMLP
from dfd_tpu.models.atari import AtariCNN as JAtariCNN
from dfd_tpu.models.impala import ImpalaPolicy as JImpalaPolicy
from dfd_tpu.utils import factory as jfactory
from dfd_tpu_torch import parity
from dfd_tpu_torch.models import AtariCNN, DiscreteMLP, GaussianMLP, ImpalaPolicy
from dfd_tpu_torch.utils import factory

import test_torch_sequential as seq
from test_torch_sequential import _assert_same_run

CPU = "cpu"

MODELS = {
    "discrete": (lambda: JDiscreteMLP(2, 9), lambda: DiscreteMLP(2, 9, device=CPU)),
    "discrete-wide": (lambda: JDiscreteMLP(6, 3, hidden=(32, 16, 8)),
                      lambda: DiscreteMLP(6, 3, hidden=(32, 16, 8), device=CPU)),
    "gaussian": (lambda: JGaussianMLP(16, 6), lambda: GaussianMLP(16, 6, device=CPU)),
    "atari": (lambda: JAtariCNN((84, 84), 6), lambda: AtariCNN((84, 84), 6, device=CPU)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_reference_init_flat_equals_jax(name):
    jm, pm = (make() for make in MODELS[name])
    for meta in ("linear_names", "weighted_layer_names"):
        assert getattr(pm, meta)() == getattr(jm, meta)()
    if hasattr(jm, "reference_module_specs"):
        assert pm.reference_module_specs() == jm.reference_module_specs()
    else:
        assert pm.reference_linear_dims() == jm.reference_linear_dims()
    torch.manual_seed(17)
    want = np.asarray(jparity.reference_init_flat(jm, 123))
    after_jax = torch.get_rng_state()
    torch.manual_seed(17)
    got = parity.reference_init_flat(pm, 123)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert torch.equal(torch.get_rng_state(), after_jax)  # the same draws consumed
    # the residue: not the plain normc init, bit for bit
    assert not np.array_equal(want, np.asarray(jm.get_flat(jm.init(123)[0])))


@pytest.mark.parametrize("lstm", [True, False])
def test_reference_impala_init_flat_equals_jax(lstm):
    kw = dict(channels=(4, 8), hidden=16, use_lstm=lstm)
    jm, pm = JImpalaPolicy((3, 16, 16), 5, **kw), ImpalaPolicy((3, 16, 16), 5, device=CPU, **kw)
    assert pm.reference_module_specs() == jm.reference_module_specs()
    assert pm.reference_construction_names() == jm.reference_construction_names()
    torch.manual_seed(3)
    want = np.asarray(jparity.reference_impala_init_flat(jm))
    torch.manual_seed(3)
    got = parity.reference_impala_init_flat(pm)
    np.testing.assert_array_equal(got, want)


def test_replay_construction_draws_equal_jax():
    specs = [(3, 4), ("linear", 4, 2), ("conv2d", 2, 3, 3, 3), ("lstm", 5, 4)]
    torch.manual_seed(8)
    want = jparity.replay_construction_draws(specs)
    torch.manual_seed(8)
    got = parity.replay_construction_draws(specs)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        else:
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_torch_sampler_streams_equal_jax():
    """Seeded, the construction replayed, then interleaved categorical and
    normal draws: the same samples; a draw from the global generator
    between them moves neither stream."""
    rng = np.random.RandomState(0)
    probs = [rng.dirichlet(np.ones(9)).astype(np.float32) for _ in range(30)]
    means = [rng.randn(6).astype(np.float32) for _ in range(30)]
    out = []
    for mod in (jparity, parity):
        s = mod.TorchSampler(123)
        s.replay_construction(DiscreteMLP(2, 9, device=CPU).reference_linear_dims())
        seq = []
        for p, m in zip(probs, means):
            seq.append(s.sample_categorical(p))
            torch.rand(5)  # another user of the global generator
            seq.append(s.sample_normal(m, np.full(6, 0.5, np.float32)))
        out.append(seq)
    assert out[0] == out[1]
    assert len({a for a in out[0][::2]}) > 3


def test_torch_sampler_feeds_the_host_policy():
    """``HostPolicy(sampler=TorchSampler)``: its sampled actions are the
    sampler's stream over the policy's probabilities."""
    from dfd_tpu_torch.runners import HostPolicy

    model = DiscreteMLP(2, 9, device=CPU)
    policy = HostPolicy(model, seed=5, sampler=parity.TorchSampler(4))
    twin = parity.TorchSampler(4)
    obs = np.random.RandomState(1).rand(25, 2).astype(np.float32)
    got = [policy.get_action(o) for o in obs]
    want = [twin.sample_categorical(policy.forward(o)[0, 0].numpy()) for o in obs]
    assert got == want


def _parity_runner_kw(model_j, model_p, seed):
    """Each package's initial flat and TorchSampler, built as the reference
    runner builds them: seed torch, construct (the draws), then sample."""
    out = []
    for mod, model in ((jparity, model_j), (parity, model_p)):
        torch.manual_seed(seed)
        flat = np.asarray(mod.reference_init_flat(model, seed))
        out.append(dict(initial_flat=flat, sampler=mod.TorchSampler()))
    return out


def test_sequential_trap_with_torch_sampler_matches_jax():
    """The trap env, 2 epochs of 8, evals at 0.3, each package's runner
    given its parity init and TorchSampler: equal actions, rewards,
    returns and omega; ``flat`` within rtol 1e-5; zeta, the visited
    observations, within the trap observation's one ulp between XLA's CPU
    division and PyTorch's."""
    seed = 123
    jenv, jmodel, jdist = jfactory.get_init_data("SimpleTrapEnv-v0", seed)
    penv, pmodel, pdist = factory.get_init_data("SimpleTrapEnv-v0", seed, CPU)
    jkw, pkw = _parity_runner_kw(jmodel, pmodel, seed)
    np.testing.assert_array_equal(jkw["initial_flat"], pkw["initial_flat"])
    kw = dict(batch_size=8, zeta_size=16, max_strategy_history_size=16, random_seed=seed,
              eval_prob=0.3, learning_rate=0.01, noise_std=0.02)
    j = seq.JSequentialRunner(jmodel, seq._Tape(jenv), jdist,
                              reporter=seq.JEpochReporter(quiet=True), **kw, **jkw)
    p = seq.SequentialRunner(pmodel, seq._Tape(penv), pdist,
                             reporter=seq.EpochReporter(quiet=True), **kw, **pkw)
    for r in (j, p):
        r.tape, r.returns = r.env, seq._log_returns(r)
        r.train(2)
    assert len(p.tape.actions) > 0
    zeta_j = j.zeta.copy()
    np.testing.assert_allclose(p.zeta, zeta_j, rtol=1.2e-7, atol=0)
    p.zeta = zeta_j  # the rest of the run exactly
    _assert_same_run(j, p)
