"""Counter-keyed perturbation noise: the port of
``dfd_tpu.core.noise.CounterNoise``.

A perturbation travels as the integer pair ``(epoch, member_id)`` and its
noise is regenerated anywhere as ``normal(fold_in(fold_in(key(seed),
epoch), member_id))``, JAX's threefry normal (``jax.random.normal``).  The
member keys are computed on the host with the port's numpy threefry
(:mod:`dfd_tpu_torch.envs._levels`) and handed to the device as an int32
``[draws, 2]`` tensor holding the uint32 words; the normals are drawn by
:func:`dfd_tpu_torch.ops.noise.normal` (``normal_kernel`` on the card).

With ``antithetic=True`` members 2k and 2k + 1 share the draw of key
``(epoch, k)`` with signs + and -.

Blocks of members are consecutive ids (``generate_block``,
``perturb_block``): one launch draws a block, each antithetic pair once.
``prepare`` moves an epoch's keys to the device once, so the blocks of that
epoch make no host synchronisation.

The host sources of the sequential topology, as in ``dfd_tpu.core.noise``:

- :class:`CounterNoiseSampler` — a worker's stateful ``sample()`` over
  :class:`CounterNoise` (on the card each draw is one ``normal_kernel``
  launch);
- :class:`RNGNoiseSource`, :class:`SimpleNoiseSource` and
  :class:`SharedNoiseTable` — numpy sources with the reference's
  encode/decode contract, copies of the JAX package's (the same numpy
  streams, bit for bit).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.envs import _levels
from dfd_tpu_torch.ops import noise as noise_ops

_MASK = 0xFFFFFFFF


def _consecutive(member_ids) -> Tuple[int, int]:
    """(first id, count) of a block of consecutive member ids."""
    ids = np.asarray(member_ids.cpu() if torch.is_tensor(member_ids) else member_ids,
                     np.int64).reshape(-1)
    if ids.size and not np.array_equal(ids, ids[0] + np.arange(ids.size)):
        raise ValueError("member_ids must be consecutive ids")
    return (int(ids[0]) if ids.size else 0), int(ids.size)


class CounterNoise:
    """Stateless counter-based Gaussian noise keyed by (epoch, member id)."""

    def __init__(self, n_params: int, random_seed: int = 123, antithetic: bool = False,
                 device=None):
        self.n_params = int(n_params)
        seed = int(random_seed)
        # jax.random.key(seed): the words (seed >> 32, seed & 0xFFFFFFFF)
        self.base_key = np.array([(seed >> 32) & _MASK, seed & _MASK], np.uint32)
        self.antithetic = bool(antithetic)
        self.device = resolve_device(device)
        self._prepared: Optional[Tuple[int, torch.Tensor]] = None

    def member_key(self, epoch: int, member_id) -> np.ndarray:
        """uint32 key words [..., 2] of draw ``member_id`` (an int or an
        array of ids) in ``epoch``."""
        epoch_key = _levels.fold_in(self.base_key, np.uint32(int(epoch) & _MASK))
        return _levels.fold_in(epoch_key, np.asarray(member_id, np.int64).astype(np.uint32))

    def prepare(self, epoch: int, members: int) -> None:
        """Move the keys of members 0 .. members - 1 in ``epoch`` to the
        device in one transfer that does not wait for the device; the
        blocks of those members slice them until the next ``prepare``."""
        draws = noise_ops.draw_count(int(members), self.antithetic, False)
        self._prepared = (int(epoch), self._to_device(self.member_key(epoch, np.arange(draws))))

    def _to_device(self, words: np.ndarray) -> torch.Tensor:
        """uint32 key words [..., 2] as an int32 [draws, 2] tensor on the
        device, copied from pinned memory without a host synchronisation."""
        host = torch.from_numpy(np.ascontiguousarray(words).reshape(-1, 2).view(np.int32))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _keys(self, epoch: int, start: int, count: int) -> Tuple[torch.Tensor, bool]:
        """The draws' keys of members start .. start + count - 1 on the
        device (a slice of the prepared ones where they cover the block),
        and whether the block starts with an odd antithetic member."""
        first, odd = (start // 2, bool(start % 2)) if self.antithetic else (start, False)
        draws = noise_ops.draw_count(count, self.antithetic, odd)
        prepared = self._prepared
        if prepared is not None and prepared[0] == int(epoch) and \
                first + draws <= prepared[1].shape[0]:
            return prepared[1][first:first + draws], odd
        return self._to_device(self.member_key(epoch, first + np.arange(draws))), odd

    def generate_block(self, epoch: int, member_ids: Sequence[int]) -> torch.Tensor:
        """float32 [len(ids), d]: the noise of consecutive member ids."""
        start, count = _consecutive(member_ids)
        keys, odd = self._keys(epoch, start, count)
        eps, _ = noise_ops.normal(keys, count, self.n_params, antithetic=self.antithetic,
                                  odd_first=odd)
        return eps

    def generate(self, epoch: int, member_id: int) -> torch.Tensor:
        """float32 [d] standard-normal noise for one population member."""
        return self.generate_block(epoch, [member_id])[0]

    def perturb_block(self, flat: torch.Tensor, sigma: float, epoch: int,
                      member_ids: Sequence[int], with_eps: bool = False,
                      theta_row: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(theta + sigma * eps [n (+1), d], eps [n, d] or None) of
        consecutive member ids in one launch; ``theta_row`` appends theta
        itself as the last row (the eval slot)."""
        start, count = _consecutive(member_ids)
        keys, odd = self._keys(epoch, start, count)
        eps, pert = noise_ops.normal(keys, count, self.n_params, antithetic=self.antithetic,
                                     odd_first=odd, theta=flat, sigma=sigma, eps=with_eps,
                                     theta_row=theta_row)
        return pert, eps

    # reference-style host API ---------------------------------------------------

    def sample(self, epoch: int = 0, member_id: int = 0):
        encoded = "{},{}".format(int(epoch), int(member_id))
        return encoded, self.generate(int(epoch), int(member_id)).cpu().numpy()

    def decode(self, encoded: str) -> np.ndarray:
        epoch, member_id = (int(x) for x in encoded.split(","))
        return self.generate(epoch, member_id).cpu().numpy()


class CounterNoiseSampler:
    """Stateful sampling facade over :class:`CounterNoise` for thin workers.

    The Worker's duck-type is ``sample() -> (encoded, noise)`` with no
    arguments; this wraps the stateless counter scheme with a per-client
    member counter (offset by the client's minted seed for global
    uniqueness), so the learner regenerates each vector from its
    "(epoch, member)" encoding.  ``Worker.update`` pushes each broadcast
    epoch through :meth:`set_epoch`; the member counter stays monotone
    across epochs."""

    def __init__(self, base: CounterNoise, id_offset: int = 0):
        self.base = base
        self.n_params = base.n_params
        self._next = int(id_offset) & 0x3FFFFFFF
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = max(int(epoch), 0)
        # antithetic pairs (2k, 2k+1) share one epoch key: re-align an odd
        # counter so that no mirrored pair straddles an epoch boundary
        if self.base.antithetic and self._next % 2:
            self._next = (self._next + 1) & 0x7FFFFFFF

    def sample(self):
        member = self._next
        self._next = (self._next + 1) & 0x7FFFFFFF
        return self.base.sample(epoch=self._epoch, member_id=member)

    def decode(self, encoded: str) -> np.ndarray:
        return self.base.decode(encoded)


class RNGNoiseSource:
    """PCG64-replay noise: encode = the 128-bit generator state, "state,inc",
    the reference's default source's wire format and stream (through
    ``bit_generator.state``, which numpy 2 still serves)."""

    def __init__(self, n_params: int, random_seed: int = 123):
        self.rng = np.random.default_rng(np.random.SeedSequence(random_seed))
        self._template_state = self.rng.bit_generator.state
        self.n_params = int(n_params)

    def sample(self):
        st = self.rng.bit_generator.state["state"]
        encoded = "{},{}".format(st["state"], st["inc"])
        return encoded, self.rng.standard_normal(size=self.n_params)

    def decode(self, encoded: str):
        state_str, inc_str = encoded.split(",")
        st = dict(self._template_state)
        st["state"] = {"state": int(state_str), "inc": int(inc_str)}
        st["has_uint32"] = 0
        st["uinteger"] = 0
        self.rng.bit_generator.state = st
        return self.rng.standard_normal(size=self.n_params)


class SimpleNoiseSource:
    """Noise ships verbatim (encode = the vector itself)."""

    def __init__(self, n_params: int, random_seed: int = 123):
        self.rng = np.random.RandomState(random_seed)
        self.n_params = int(n_params)

    def sample(self):
        noise = self.rng.randn(self.n_params)
        return noise, noise

    def decode(self, encoded):
        return encoded


class SharedNoiseTable:
    """OpenAI-ES-style pre-generated table; encode = a start index."""

    def __init__(self, size: int, n_params: int, random_seed: int = 123):
        if size <= n_params:
            raise ValueError(
                "noise table size {} must exceed parameter count {}".format(size, n_params)
            )
        self._rng = np.random.RandomState(random_seed)
        self._table = self._rng.randn(size).astype(np.float32)
        self._n_params = int(n_params)
        self._max_sample_idx = size - n_params

    def sample(self):
        idx = self._rng.randint(0, self._max_sample_idx)
        return str(idx), self._table[idx : idx + self._n_params]

    def decode(self, encoded):
        idx = int(encoded)
        return self._table[idx : idx + self._n_params]
