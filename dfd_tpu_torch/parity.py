"""Reference-parity helpers, a copy of ``dfd_tpu.parity``.

Two reference behaviors are tied to torch's global CPU generator and must
be replayed exactly for bit-level parity runs on simple_trap_env
(BASELINE.md "Exactness" target):

1. **Initialization residue.**  The reference's normc init *overwrites*
   torch's default (kaiming) init via ``w += (normc_w - w)`` in float32
   (reference policies/policy.py:105-112).  ``a + (b - a)`` is not ``b`` in
   floating point, so the shipped initial weights carry a 1-ulp residue that
   depends on torch's default draws.  :func:`reference_init_flat` replays the
   construction (torch draws + normc overwrite) and returns the exact flat.

2. **Stochastic action sampling.**  Non-eval episodes sample actions with
   ``torch.distributions`` from torch's *global* generator, seeded once by the
   runner (reference run_sequential.py:64, policies/discrete.py:21-24).
   :class:`TorchSampler` reproduces the draw stream: it seeds torch the same
   way, replays the construction-time draws, then serves per-step samples.
   It plugs into :class:`~dfd_tpu_torch.runners.HostPolicy` and
   :class:`~dfd_tpu_torch.runners.SequentialRunner` as ``sampler=``.

Both replay on the CPU whatever device the model lives on: the draws are
the CPU generator's, and the flats come back as numpy float32 vectors, as
the JAX package's do (what ``SequentialRunner(initial_flat=...)`` takes).  Nothing
else on the sequential path draws from the global generator (every trainer
and env draw takes its own ``torch.Generator``), and the sampler swaps its
own state in and out around each draw, so its stream is isolated.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def replay_construction_draws(module_specs):
    """Construct torch modules in reference order, consuming the global RNG
    exactly as the reference policy constructor does, and return their default
    (weight, bias) tensors as numpy float32.

    ``module_specs`` entries: ``(d_in, d_out)`` or ``("linear", d_in, d_out)``
    for Linear; ``("conv2d", in_ch, out_ch, kh, kw)`` for Conv2d.
    """
    out = []
    with torch.no_grad():
        for spec in module_specs:
            if isinstance(spec, tuple) and spec and spec[0] == "conv2d":
                _, c_in, c_out, kh, kw = spec
                mod = torch.nn.Conv2d(c_in, c_out, kernel_size=(kh, kw))
            elif isinstance(spec, tuple) and spec and spec[0] == "lstm":
                _, d_in, hidden = spec
                mod = torch.nn.LSTM(d_in, hidden, num_layers=1, batch_first=True)
                out.append(
                    {
                        "w_ih": mod.weight_ih_l0.numpy().copy(),
                        "w_hh": mod.weight_hh_l0.numpy().copy(),
                        "b_ih": mod.bias_ih_l0.numpy().copy(),
                        "b_hh": mod.bias_hh_l0.numpy().copy(),
                    }
                )
                continue
            elif isinstance(spec, tuple) and spec and spec[0] == "linear":
                _, d_in, d_out = spec
                mod = torch.nn.Linear(d_in, d_out)
            else:
                d_in, d_out = spec
                mod = torch.nn.Linear(d_in, d_out)
            out.append((mod.weight.numpy().copy(), mod.bias.numpy().copy()))
    return out


def reference_impala_init_flat(model) -> np.ndarray:
    """Exact initial trainable flat of the reference ImpalaPolicy.

    The reference's normc init is a no-op for this policy (its top-level
    Sequential has no weighted layers, policy.py:96-101), so the init IS
    torch's construction defaults.  Replays the drawing modules in
    construction order and assembles them into the model's param tree
    (BatchNorms keep ones/zeros), as a numpy float32 vector.  Requires
    torch.manual_seed to match the reference runner's seeding.
    """
    defaults = replay_construction_draws(model.reference_module_specs())
    names = model.reference_construction_names()
    params, _ = model.init(0)
    t = lambda a: torch.as_tensor(a, device=model.device)
    for name, drawn in zip(names, defaults):
        if isinstance(drawn, dict):
            params[name] = {k: t(v.copy()) for k, v in drawn.items()}
        else:
            w, b = drawn
            params[name] = {"w": t(w), "b": t(b)}
    return model.get_flat(params).cpu().numpy()


def reference_init_flat(model, seed: int) -> np.ndarray:
    """The reference policy's exact initial trainable flat for ``model``.

    ``model`` is a port PolicyModel whose ``reference_linear_dims`` and
    ``reference_weight_shapes`` describe the torch construction; the normc
    draws come from the model's own init (same numpy stream), and the
    overwrite residue is applied here; the flat is a numpy float32 vector.
    Requires torch's global generator to be pre-seeded exactly like the
    reference runner (torch.manual_seed).
    """
    specs = (
        model.reference_module_specs()
        if hasattr(model, "reference_module_specs")
        else model.reference_linear_dims()
    )
    defaults = replay_construction_draws(specs)
    params, _ = model.init(seed)

    default_by_linear = dict(zip(model.linear_names(), defaults))
    t = lambda a: torch.as_tensor(a, device=model.device)
    for name in model.weighted_layer_names():
        p = params[name]
        w = p["w"].cpu().numpy()
        if name in default_by_linear:
            dw, _db = default_by_linear[name]
        else:  # BatchNorm default: weight=ones (no RNG draws)
            dw = np.ones_like(w)
        # w_final = default + (normc - default), computed in float32
        p["w"] = t((dw + (w - dw)).astype(np.float32))
        # bias: default + (-default) == exactly 0.0
        p["b"] = torch.zeros_like(p["b"])
    return model.get_flat(params).cpu().numpy()


class TorchSampler:
    """Action sampler reproducing the reference's torch global-RNG stream.

    Seed via ``torch.manual_seed(seed)`` (or :func:`seed`), then call
    :func:`replay_construction` once (the reference constructs its policy
    after seeding, which consumes generator state), and use the ``sample_*``
    methods during rollouts.

    The sampler snapshots the global generator state after construction and
    swaps it in/out around every draw, so its stream is isolated: other torch
    users in the process (e.g. a reference oracle running side-by-side in a
    parity test) cannot perturb it.
    """

    def __init__(self, seed: int | None = None):
        if seed is not None:
            self.seed(seed)
        else:
            self._state = torch.get_rng_state()

    def seed(self, seed: int) -> None:
        torch.manual_seed(seed)
        self._state = torch.get_rng_state()

    def replay_construction(self, layer_dims: Sequence[Tuple[int, int]]) -> None:
        torch.set_rng_state(self._state)
        replay_construction_draws(layer_dims)
        self._state = torch.get_rng_state()

    def _swap_in(self):
        saved = torch.get_rng_state()
        torch.set_rng_state(self._state)
        return saved

    def _swap_out(self, saved) -> None:
        self._state = torch.get_rng_state()
        torch.set_rng_state(saved)

    def sample_categorical(self, probs: np.ndarray) -> int:
        saved = self._swap_in()
        try:
            with torch.no_grad():
                distr = torch.distributions.Categorical(
                    probs=torch.as_tensor(np.asarray(probs, np.float32).copy()).view(1, -1)
                )
                return int(distr.sample().item())
        finally:
            self._swap_out(saved)

    def sample_normal(self, mean: np.ndarray, std: np.ndarray) -> List[float]:
        saved = self._swap_in()
        try:
            with torch.no_grad():
                distr = torch.distributions.Normal(
                    torch.as_tensor(np.asarray(mean, np.float32).copy()),
                    torch.as_tensor(np.asarray(std, np.float32).copy()),
                )
                return distr.sample().flatten().tolist()
        finally:
            self._swap_out(saved)
