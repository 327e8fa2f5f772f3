"""A plain Deep Finite Differences trainer: the benchmark's reference.

One epoch, as the program's ``VectorizedTrainer.train`` runs it with
``eval_every`` epochs between evaluations and one episode a member:

1. perturb: theta_i = theta + sigma eps_i, eps_i the counter noise of
   (epoch, i); the evaluation slot, member P, runs theta itself;
2. roll the P + 1 members out in lockstep for T steps: member i's action is
   the Gumbel-max sample ``argmax(log p + g)`` of its policy on the epoch's
   draws, member P's the greedy ``argmax p``; rewards, entropies and steps
   accumulate until each episode ends, the env and the LSTM carry frozen
   after it;
3. novelty: each member's action probabilities over zeta (one sequence,
   zero rewards) against each archived strategy, total variation summed
   over actions and averaged over zeta, the least of them; zero while the
   archive holds fewer than two strategies;
4. on evaluation epochs the exponential averages of the evaluation
   episode's reward, entropy and novelty (0.9 old, 0.1 new), zeta's slots
   ``perm[j]`` replaced by the evaluation episode's j-th observation for j
   below its steps, and the omega schedule stepped on the mean reward;
5. fitness: the rewards less the averaged reward, standardized by their
   population deviation, or the epoch's tie signs where that is zero;
6. combine: g = sum_i f_i sigma eps_i / ||sigma eps_i||^2;
7. DSGD: theta += lr sqrt(d) scale(omega) g / ||g||;
8. between epochs, on evaluation epochs, every archived policy's strategy
   re-evaluated on the new zeta, then the new policy submitted: appended
   while the archive has room, else put in place of the least novel point
   (one end of the closest pair, the one with the nearer second
   neighbour) where its novelty exceeds that pair's distance.

:meth:`DFD.run` runs epochs free (its own actions and archive decisions: the
control, and the planted faults) or follows a :class:`Record` of another
trainer (its actions and its archive's members) and measures how far that
trainer's outputs lie from its own; following, it replays every member's
episode through the env and runs the policy for the judged members alone,
whose actions it judges.  Products in float64 where the program
takes them in float32 (fitness, combine, DSGD); the policy at its own
precision (``reference/impala.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

ILLEGAL = 100.0  # an archive outcome no single submission explains (distances are <= 2)
FAULTS = ("unchanged", "half_batch", "altered")


@dataclasses.dataclass
class Settings:
    """What the cell's workload and the trainer's defaults fix."""

    P: int
    T: int
    Z: int
    H: int
    learning_rate: float
    noise_std: float
    eval_every: int
    noise_seed: int
    omega_default: float
    omega_threshold: float
    omega_history: int
    omega_min: float
    omega_max: float
    omega_steps_to_min: int
    omega_steps_to_max: int
    dsgd_min_scale: float
    dsgd_max_scale: float


@dataclasses.dataclass
class Record:
    """What one trainer did in its first epochs: theta and zeta before epoch
    0 and after each epoch, each epoch's actions [T, P + 1], its reported
    metrics, and its archive's members after it (as indices s of theta_s)."""

    theta: List[torch.Tensor] = dataclasses.field(default_factory=list)
    zeta: List[torch.Tensor] = dataclasses.field(default_factory=list)
    actions: List[torch.Tensor] = dataclasses.field(default_factory=list)
    metrics: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    archive: List[List[int]] = dataclasses.field(default_factory=list)


def tvd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Total variation (without the 1/2) summed over actions, mean over zeta."""
    return (p - q).abs().sum(-1).mean(-1)


class _Archive:
    """The policy archive: member indices s, the flats theta_s, and the
    strategies evaluated on the current zeta."""

    def __init__(self, H: int):
        self.H = H
        self.members: List[int] = []
        self.n_evaluated = 0  # members whose strategies the novelty reads

    def neighbours(self, strat: Dict[int, torch.Tensor]):
        """(closest [n] as (pair, dist), second closest [n], worst index),
        with the program's order of pairs and its strict comparisons."""
        n = len(self.members)
        pairs = [((i, j), float(tvd(strat[self.members[i]], strat[self.members[j]])))
                 for i in range(n) for j in range(i + 1, n)]
        closest = [[None, math.inf] for _ in range(n)]
        second = [[None, math.inf] for _ in range(n)]
        for i in range(n):
            for key, dist in pairs:
                if i not in key:
                    continue
                if dist < closest[i][1]:
                    second[i] = closest[i][:]
                    closest[i] = [key, dist]
                elif dist < second[i][1] and key != closest[i][0]:
                    second[i] = [key, dist]
        worst, worst_dist = 0, math.inf
        for i in range(n):
            key, dist = closest[i]
            if dist < worst_dist and key is not None:
                other = key[1 - key.index(i)]
                worst_dist = dist
                worst = i if second[i][1] < second[other][1] else other
        return closest, second, worst


class DFD:
    """The reference trainer of one cell: ``policy`` and ``env`` the plain
    modules, ``draws(epoch)`` the epoch's draws (gumbel [P+1, 1, T, A],
    stats uniforms, tie signs [P], zeta's permutation [Z], levels [P+1, 1])
    and ``noise(seed, epoch, P, d, device)`` the members' eps [P, d]."""

    def __init__(self, policy, env, settings: Settings, draws: Callable, noise: Callable,
                 device, fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
        self.policy, self.env, self.s = policy, env, settings
        self.draws, self.noise = draws, noise
        self.device = torch.device(device)
        self.fault = fault

    # -- one epoch's pieces --------------------------------------------------------

    def _rollout(self, theta_rows, draws, epoch: int, follow: Optional[torch.Tensor],
                 judged: Optional[torch.Tensor]):
        """The P + 1 members' episodes: (reward, entropy, steps [M], the
        evaluation member's first Z observations, actions [T, M], widest
        action gap).  Following another trainer's actions, the policy runs
        for the ``judged`` members alone (all where None) and every episode
        is replayed through the env; entropies are of the judged members."""
        s, env, pol = self.s, self.env, self.policy
        M, dev = theta_rows.shape[0], self.device
        if follow is None or judged is None:
            judged, p = torch.arange(M, device=dev), _unflatten(theta_rows, pol.layout)
        else:
            judged = judged.to(dev)
            p = _unflatten(theta_rows[judged], pol.layout)
        det = judged == s.P
        state, obs = env.reset(draws[4][:, 0])
        carry = tuple(torch.zeros((judged.shape[0], 1, pol.hidden), device=dev)
                      for _ in range(2))
        prev_reward = torch.zeros(M, device=dev)
        prev_done = torch.zeros(M, dtype=torch.bool, device=dev)
        acc_r, acc_e = torch.zeros(M, device=dev), torch.zeros(M, device=dev)
        steps = torch.zeros(M, dtype=torch.int64, device=dev)
        seen, actions, gap = [], [], torch.zeros((), device=dev)
        for t in range(s.T):
            probs, new_carry = pol.step(p, obs[judged][:, None], prev_reward[judged][:, None],
                                        carry)
            probs = probs[:, 0]
            logp = torch.log(probs.clamp_min(1e-38))
            score = torch.where(det[:, None], logp, logp + draws[0][judged, 0, t])
            if follow is not None:
                a = follow[t].to(dev)
            else:
                a = score.argmax(-1)
                if self.fault == "altered" and epoch == 0 and t == 0:
                    a[:s.P] = score[:s.P].argmin(-1)
            active = ~prev_done
            mine = active[judged]
            behind = score.amax(-1) - score.gather(1, a[judged][:, None])[:, 0]
            gap = torch.maximum(gap, torch.where(mine, behind, 0.0).amax())
            pos = probs > 0
            ent = -torch.where(pos, probs * torch.log(torch.where(pos, probs, 1.0)), 0.0).sum(-1)
            new_state, new_obs, reward, done = env.step(state, a)
            if t < s.Z:
                seen.append(obs[s.P])
            af = active.to(torch.float32)
            acc_r, steps = acc_r + af * reward, steps + active.long()
            acc_e.index_add_(0, judged, mine.to(torch.float32) * ent)
            state = env.keep(prev_done, new_state, state)
            keep = prev_done[judged][:, None, None]
            carry = tuple(torch.where(keep, o, n) for n, o in zip(new_carry, carry))
            obs = torch.where(prev_done[:, None, None, None], obs, new_obs)
            prev_reward = torch.where(prev_done, prev_reward, reward)
            prev_done = prev_done | done
            actions.append(a)
        entropy = acc_e / steps.clamp_min(1).to(torch.float32)
        return acc_r, entropy, steps, torch.stack(seen), torch.stack(actions), float(gap)

    def _novelty(self, theta_rows, zeta, archive: Optional[torch.Tensor]) -> torch.Tensor:
        if archive is None:
            return torch.zeros(theta_rows.shape[0], device=self.device)
        strat = self.policy.strategy(_unflatten(theta_rows, self.policy.layout), zeta)
        return tvd(strat[:, None], archive[None]).amin(1)

    def _strategy(self, theta: torch.Tensor, zeta: torch.Tensor) -> torch.Tensor:
        return self.policy.strategy(_unflatten(theta[None], self.policy.layout), zeta)[0]

    def _omega(self, om, reward: torch.Tensor):
        """The omega schedule's step, in the program's float32 arithmetic."""
        s = self.s
        omega, history, filled, cursor = om
        h = history.shape[0]
        idx = torch.arange(h, device=self.device)
        history = torch.where(idx == cursor, reward, history)
        filled, cursor = min(filled + 1, h), (cursor + 1) % h
        mean = torch.where(idx < filled, history, 0.0).sum() / max(filled, 1)
        mean = torch.round(mean * 1e5) / 1e5
        r = torch.round(reward * 1e5) / 1e5
        mean = torch.where(mean < 0, mean / s.omega_threshold, mean * s.omega_threshold)
        omega = torch.where(r > mean,
                            torch.clamp_min(omega - 1.0 / s.omega_steps_to_min, s.omega_min),
                            torch.clamp_max(omega + 1.0 / s.omega_steps_to_max, s.omega_max))
        return omega, history, filled, cursor

    # -- the run -------------------------------------------------------------------

    def run(self, theta0: torch.Tensor, zeta0: torch.Tensor, epochs: int,
            follow: Optional[Record] = None, judged: Optional[torch.Tensor] = None):
        """``epochs`` epochs from theta0 and zeta0: (this trainer's Record,
        the gaps to ``follow``'s outputs, or None when running free); the
        policy judges the actions of the ``judged`` members (all where
        None)."""
        s, dev = self.s, self.device
        theta = theta0.to(dev, torch.float32)
        zeta = zeta0.to(dev, torch.float32)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        pr, pe, pn = f32(0.0), f32(0.0), f32(0.0)
        om = (f32(s.omega_default), torch.zeros(s.omega_history, device=dev), 0, 0)
        rec = Record(theta=[theta.cpu()], zeta=[zeta.cpu()])
        flats = {0: theta}
        arch = _Archive(s.H)
        arch.members = [0]
        strat: Dict[int, torch.Tensor] = {}  # strategies on arch_zeta, the archive's zeta
        arch_zeta = zeta
        gaps = dict(action_gap=0.0, reward_gap=0.0, novelty_gap=0.0, update_gap=0.0,
                    zeta_gap=0.0, archive_gap=0.0)
        for k in range(epochs):
            draws = self.draws(k)
            count = arch.n_evaluated
            archive = torch.stack([strat[m] for m in arch.members[:count]]) if count >= 2 else None
            eps = self.noise(s.noise_seed, k, s.P, theta.numel(), dev)
            rows = torch.cat([theta[None] + s.noise_std * eps, theta[None]])
            reward, entropy, steps, seen, actions, gap = self._rollout(
                rows, draws, k, None if follow is None else follow.actions[k], judged)
            novelty = self._novelty(rows, zeta, archive)
            del rows
            n = s.P // 2 if self.fault == "half_batch" else s.P
            rewards = reward[:n]
            noisy_reward, noisy_novelty = rewards.mean(), novelty[:n].mean()
            new_om, new_zeta = om, zeta
            if k % s.eval_every == 0:
                ema = lambda old, new: old * 0.9 + new * 0.1
                pr, pe, pn = ema(pr, reward[s.P]), ema(pe, entropy[s.P]), ema(pn, novelty[s.P])
                valid = (torch.arange(s.Z, device=dev) < min(int(steps[s.P]), s.Z))
                new_zeta = zeta.clone()
                new_zeta[draws[3]] = torch.where(valid[:, None, None, None], seen, zeta[draws[3]])
                new_om = self._omega(om, noisy_reward)
            shifted = rewards.double() - float(pr)
            std = ((shifted - shifted.mean()) ** 2).mean().sqrt()
            fitness = (draws[2][:n].double() if std == 0 else (shifted - shifted.mean()) / std)
            sq = (eps[:n].double() ** 2).sum(1) * s.noise_std ** 2
            w = fitness * s.noise_std / sq.clamp_min(1e-30)
            g = torch.zeros(theta.numel(), dtype=torch.float64, device=dev)
            for i0 in range(0, n, 16):
                g += w[i0:i0 + 16] @ eps[i0:min(i0 + 16, n)].double()
            del eps
            scale = (float(new_om[0]) - s.omega_min) * (s.dsgd_max_scale - s.dsgd_min_scale) / \
                (s.omega_max - s.omega_min) + s.dsgd_min_scale
            norm = float(g.norm())
            coef = s.learning_rate * math.sqrt(theta.numel()) * scale / norm if norm > 0 else 0.0
            new_theta = (theta.double() + coef * g).float()
            if self.fault == "unchanged":
                new_theta, new_zeta, new_om = theta, zeta, om
            update = float((new_theta - theta).norm())
            metrics = {"Noisy Reward": float(noisy_reward), "Noisy Novelty": float(noisy_novelty),
                       "Policy Reward": float(pr), "Policy Novelty": float(pn),
                       "Update Magnitude": update}
            theta, zeta, om = new_theta, new_zeta, new_om
            flats[k + 1] = theta
            # between epochs: the archive re-evaluated on the new zeta, then the new policy
            before = list(arch.members)
            decision = None
            if k % s.eval_every == 0:
                arch_zeta = zeta
                strat = {m: self._strategy(flats[m], zeta) for m in arch.members}
                arch.n_evaluated = len(arch.members)
            if update > 0:
                decision = self._submit(arch, strat, flats, k + 1, arch_zeta)
            rec.theta.append(theta.cpu())
            rec.zeta.append(zeta.cpu())
            rec.actions.append(actions.cpu())
            rec.metrics.append(metrics)
            rec.archive.append(list(arch.members))
            if follow is None:
                continue
            theirs = follow.metrics[k]
            gaps["action_gap"] = max(gaps["action_gap"], gap)
            gaps["reward_gap"] = max(gaps["reward_gap"], *(
                abs(theirs[key] - metrics[key]) for key in ("Noisy Reward", "Policy Reward")))
            gaps["novelty_gap"] = max(gaps["novelty_gap"], *(
                abs(theirs[key] - metrics[key]) for key in ("Noisy Novelty", "Policy Novelty")))
            mine_d = rec.theta[-1] - rec.theta[-2]
            their_d = follow.theta[k + 1] - follow.theta[k]
            gaps["update_gap"] = max(gaps["update_gap"], _direction_gap(their_d, mine_d))
            gaps["zeta_gap"] = max(gaps["zeta_gap"],
                                   float((follow.zeta[k + 1] - rec.zeta[-1]).abs().max()))
            gaps["archive_gap"] = max(gaps["archive_gap"], _archive_gap(
                arch, strat, before, follow.archive[k], decision, k + 1))
            # the program's members from here on, so that one near tie does not compound
            arch.members = list(follow.archive[k])
            grew = len(arch.members) > len(before)
            arch.n_evaluated = len(arch.members) - (1 if grew else 0)
            for m in arch.members:
                if m not in strat:
                    strat[m] = self._strategy(flats[m], arch_zeta)
        if follow is not None:
            gaps["grad_gap"] = _leaf_gap(self.policy.layout, follow.theta[1] - follow.theta[0],
                                         rec.theta[1] - rec.theta[0])
            gaps["change_gap"] = _leaf_gap(self.policy.layout,
                                           follow.theta[epochs] - follow.theta[0],
                                           rec.theta[epochs] - rec.theta[0])
            return rec, gaps
        return rec, None

    def _submit(self, arch: _Archive, strat, flats, s_new: int, zeta):
        """Submit theta_{s_new}: appended while there is room, else the
        replacement test.  Returns what the test read: (novelty, the
        closest pair's distance, closest, second, worst), or None."""
        if len(arch.members) < arch.H:
            arch.members.append(s_new)
            return None
        strat[s_new] = self._strategy(flats[s_new], zeta)
        dists = [float(tvd(strat[s_new], strat[m])) for m in arch.members]
        closest, second, worst = arch.neighbours(strat)
        novelty, current = min(dists), closest[worst][1]
        if novelty > current or current == math.inf:
            arch.members[worst] = s_new
        return novelty, current, closest, second, worst


def _unflatten(theta, layout):
    out, i = {}, 0
    for leaf in layout:
        n = int(np.prod(leaf.shape))
        out[leaf.name] = theta[:, i:i + n].reshape((theta.shape[0],) + leaf.shape)
        i += n
    return out


def _direction_gap(theirs: torch.Tensor, mine: torch.Tensor) -> float:
    """|| theirs / ||theirs|| - mine / ||mine|| ||, 1 where theirs did not move."""
    mine = mine.double() / max(float(mine.double().norm()), 1e-300)
    n = float(theirs.double().norm())
    if n == 0:
        return 1.0
    return float((theirs.double() / n - mine).norm())


def _leaf_gap(layout, theirs: torch.Tensor, mine: torch.Tensor) -> float:
    """The worst leaf's gap of norms: | ||theirs_l|| - ||mine_l|| | over the
    larger of ||mine_l|| and the median leaf's ||mine||."""
    mine_n, theirs_n, i = [], [], 0
    for leaf in layout:
        n = int(np.prod(leaf.shape))
        mine_n.append(float(mine[i:i + n].double().norm()))
        theirs_n.append(float(theirs[i:i + n].double().norm()))
        i += n
    median = float(np.median(mine_n))
    return max(abs(t - m) / max(m, median, 1e-300) for t, m in zip(theirs_n, mine_n))


def _archive_gap(arch, strat, before: List[int], after: List[int], decision, s_new: int) -> float:
    """How far the other trainer's archive outcome lies on the wrong side of
    this one's criteria: 0 where they agree; the margin of each comparison
    it decided otherwise; :data:`ILLEGAL` where no submission of theta_{s_new}
    explains it."""
    if decision is None:  # room: appended, or nothing submitted
        expect = arch.members
        return 0.0 if list(after) == list(expect) else ILLEGAL
    novelty, current, closest, second, _ = decision
    if list(after) == list(before):  # kept out
        return 0.0 if current != math.inf and novelty <= current else \
            (novelty - current if current != math.inf else ILLEGAL)
    changed = [i for i, (a, b) in enumerate(zip(before, after)) if a != b]
    if len(after) != len(before) or len(changed) != 1 or after[changed[0]] != s_new:
        return ILLEGAL
    j = changed[0]
    gap = max(0.0, current - novelty) if current != math.inf else 0.0
    key, dist = closest[j]
    if key is None:
        return ILLEGAL
    other = key[1 - key.index(j)]
    gap += max(0.0, dist - current) + max(0.0, second[j][1] - second[other][1])
    return gap
