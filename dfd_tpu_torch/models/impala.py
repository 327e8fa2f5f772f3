"""IMPALA ResNet + LSTM policy over a population of weights.

The port of ``dfd_tpu.models.impala.ImpalaPolicy`` (see its module docstring
for the reference architecture and the quirks it keeps): per frame, x/255
-> three stages of [BatchNorm -> Conv3x3 -> MaxPool3x3/2] and two residual
blocks [BN -> ReLU -> Conv3x3 -> BN -> ReLU -> Conv3x3] with skips -> ReLU
-> flatten -> [BN -> Linear(hidden)] -> ReLU -> concat(clipped previous
reward) -> LSTM(hidden) -> [BN -> Linear(n_actions)] -> softmax.

Every leaf of ``params`` carries the population axis ``[M]``, frames are
``[M, N, C, H, W]`` (or ``[N, C, H, W]`` shared by the members), and the
BatchNorm statistics in ``state`` are shared.  The layer order, the flat
views and the numpy init draws are the JAX model's, so ``get_flat`` of the
port's init equals JAX's.

``conv_impl`` picks the same routes through the torso as the JAX model, by
the same shape gates (decided once here, from the frame shape):

- ``"patches"``: every conv as im2col (a strided view of the padded frame,
  copied once, :func:`conv3x3_patches`) and one batched product per member;
- ``"lax"``: every conv as one grouped convolution over members x
  channels (:func:`conv3x3`; cuDNN on the card, where JAX lowers its
  member-batched ``lax.conv`` outside any Pallas kernel);
- ``"split"``: the kernel's rows in the product's contraction and its
  columns in its output, then three shifted adds (:func:`conv3x3_split`);
- ``"nhwc"``: the torso in channels-last layout (:func:`conv3x3_nhwc`,
  :func:`maxpool3x3s2_nhwc`), transposed back before the flatten so that
  the fc weights' order holds;
- ``"fused"``: a stage's residual pair through the ``fused_res_stage``
  kernel where ``fused_supported(H, W)``;
- ``"fused_feat"``: also the feature block through the ``fused_feat_pool``
  kernel where ``fused_supported(H, W)``, H and W are even and the input
  channels are a multiple of 8 (the 3-channel first stage stays on patches).

The kernels' weight layouts (the tap-order reorder and the BN fold, per
member) depend on the weights alone; :meth:`ImpalaPolicy.prepare` computes
them once for a rollout instead of once per step.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dfd_tpu_torch.core.device import resolve_device
from dfd_tpu_torch.core.flat import FlatSpec
from dfd_tpu_torch.models import layers
from dfd_tpu_torch.models.atari import batchnorm2d_eval, batchnorm2d_train
from dfd_tpu_torch.models.base import Params, PolicyModel, State, sample_action
from dfd_tpu_torch.ops import fused_resblock
from dfd_tpu_torch.utils.profiling import span

CHANNELS = (16, 32, 32)
HIDDEN = 256
CONV_IMPLS = ("lax", "patches", "nhwc", "split", "fused", "fused_feat")
_PREPARED = "_fused"  # the key under which prepare() keeps the kernels' layouts


def _rounded(compute_dtype, *xs):
    """``xs`` rounded to ``compute_dtype`` and back to float32 (unchanged
    for None): the operands of a product taken in float32."""
    if compute_dtype is None:
        return xs
    return tuple(x.to(compute_dtype).to(torch.float32) for x in xs)


def conv3x3_patches(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """3x3 "same" conv as im2col + one batched product per member.

    x [M, N, ci, H, W], w [M, co, ci, 3, 3], b [M, co] -> [M, N, co, H, W].
    The patches are the 3x3 windows of the zero-padded input, a strided view
    copied once into [M, 9ci, N*H*W] with the channels ordered (ci, kh, kw),
    as JAX's ``conv_general_dilated_patches`` orders them, so
    ``w.reshape(co, 9ci)`` fits.  (``F.unfold`` computes the same patches,
    but on the card it launches one im2col kernel per image: 129 a conv at
    the flagship's rollout shapes.)"""
    w = p["w"]
    M, co, ci = w.shape[:3]
    N, H, W = x.shape[1], x.shape[3], x.shape[4]
    win = F.pad(x, (1, 1, 1, 1)).unfold(3, 3, 1).unfold(4, 3, 1)      # [M, N, ci, H, W, 3, 3]
    pat = win.permute(0, 2, 5, 6, 1, 3, 4).reshape(M, 9 * ci, N * H * W)
    wk, pat = _rounded(compute_dtype, w.reshape(M, co, 9 * ci), pat)
    y = torch.bmm(wk, pat).reshape(M, co, N, H, W).transpose(1, 2)
    return y + p["b"][:, None, :, None, None]


def conv3x3(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """3x3 "same" conv as one grouped convolution: the members' channels
    side by side, a group a member.  x [M, N, ci, H, W], w [M, co, ci, 3,
    3], b [M, co] -> [M, N, co, H, W]."""
    w = p["w"]
    M, co, ci = w.shape[:3]
    N, H, W = x.shape[1], x.shape[3], x.shape[4]
    x, w = _rounded(compute_dtype, x, w)
    xg = x.transpose(0, 1).reshape(N, M * ci, H, W)
    y = F.conv2d(xg, w.reshape(M * co, ci, 3, 3), padding=1, groups=M)
    y = y.reshape(N, M, co, H, W).transpose(0, 1)
    return y + p["b"][:, None, :, None, None]


def conv3x3_split(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """3x3 "same" conv as a (rows -> contraction, columns -> output) split
    product and three shifted adds, ``dfd_tpu.models.impala.conv3x3_split``
    per member.  The vertical-only patches [M, 3ci, N*H*W] are ordered (ci,
    dy); the weights [M, 3ci, 3co] (ci, dy) x (dx, co); the product's three
    co-wide blocks, shifted by dx - 1 columns, sum to the conv."""
    w = p["w"]
    M, co, ci = w.shape[:3]
    N, H, W = x.shape[1], x.shape[3], x.shape[4]
    win = F.pad(x, (0, 0, 1, 1)).unfold(3, 3, 1)                      # [M, N, ci, H, W, 3]
    pat3 = win.permute(0, 2, 5, 1, 3, 4).reshape(M, 3 * ci, N * H * W)
    w2 = w.permute(0, 2, 3, 4, 1).reshape(M, 3 * ci, 3 * co)
    pat3, w2 = _rounded(compute_dtype, pat3, w2)
    y3 = torch.bmm(w2.transpose(1, 2), pat3).reshape(M, 3 * co, N, H, W)
    y3p = F.pad(y3, (1, 1))
    y = (y3p[:, 0 * co:1 * co, ..., 0:W] + y3p[:, 1 * co:2 * co, ..., 1:W + 1]
         + y3p[:, 2 * co:3 * co, ..., 2:W + 2])
    return y.transpose(1, 2) + p["b"][:, None, :, None, None]


def conv3x3_nhwc(p, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """3x3 "same" conv over channels-last activations (im2col + one batched
    product per member): x [M, N, H, W, ci] -> [M, N, H, W, co].  The
    patches' channels are ordered (ci, kh, kw), so the OIHW weights'
    ``reshape(co, 9ci)`` fits."""
    w = p["w"]
    M, co, ci = w.shape[:3]
    N, H, W = x.shape[1], x.shape[2], x.shape[3]
    win = F.pad(x, (0, 0, 1, 1, 1, 1)).unfold(2, 3, 1).unfold(3, 3, 1)  # [M, N, H, W, ci, 3, 3]
    pat = win.reshape(M, N * H * W, 9 * ci)
    wk = w.reshape(M, co, 9 * ci)
    pat, wk = _rounded(compute_dtype, pat, wk)
    y = torch.bmm(pat, wk.transpose(1, 2)).reshape(M, N, H, W, co)
    return y + p["b"][:, None, None, None, :]


def maxpool3x3s2_nhwc(x: torch.Tensor) -> torch.Tensor:
    """3x3 max, stride 2, padding 1 (-inf) over [M, N, H, W, C]."""
    return maxpool3x3s2(x.permute(0, 1, 4, 2, 3)).permute(0, 1, 3, 4, 2)


def _batchnorm_nhwc(p, s, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in inference mode over the last axis of [M, N, H, W, C]."""
    pc = lambda v: v[:, None, None, None, :]
    return (x - s["mean"]) / torch.sqrt(s["var"] + layers.BN_EPS) * pc(p["w"]) + pc(p["b"])


_CONVS = {"lax": conv3x3, "split": conv3x3_split}


def maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 max, stride 2, padding 1 (-inf, as ``reduce_window``) over
    [M, N, C, H, W]."""
    M, N = x.shape[:2]
    y = F.max_pool2d(x.reshape(M * N, *x.shape[2:]), 3, stride=2, padding=1)
    return y.reshape(M, N, *y.shape[1:])


class _Stage(NamedTuple):
    feat_fused: bool  # the feature block through fused_feat_pool
    res_fused: bool   # the residual pair through fused_res_stage


class ImpalaPolicy(PolicyModel):
    discrete = True
    recurrent = True

    def __init__(
        self,
        frame_shape: Tuple[int, int, int],
        n_actions: int,
        use_lstm: bool = True,
        compute_dtype=None,
        conv_impl: str = "patches",
        channels=CHANNELS,
        hidden: int = HIDDEN,
        device=None,
    ):
        """``frame_shape``: (C, H, W) of one frame.  ``compute_dtype``: None
        or ``torch.bfloat16`` (conv and fc operands rounded to bf16, products
        accumulated in float32; the LSTM and the head stay float32)."""
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")
        if compute_dtype not in (None, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")
        self.device = resolve_device(device)
        c, h, w = (int(v) for v in frame_shape)
        self.channels = tuple(int(x) for x in channels)
        self.hidden = int(hidden)
        self.compute_dtype = compute_dtype
        self.conv_impl = conv_impl
        # the unfused convs; the VBN refresh's too, but nhwc's is the patches conv
        self._conv = _CONVS.get(conv_impl, conv3x3_patches)
        self.input_shape = (c, h, w)
        self.output_shape = int(n_actions)
        self.use_lstm = use_lstm

        # the JAX model's shape gates, stage by stage
        self._stages = []
        in_ch, hh, ww = c, h, w
        for ch in self.channels:
            feat = (conv_impl == "fused_feat" and fused_resblock.fused_supported(hh, ww)
                    and hh % 2 == 0 and ww % 2 == 0 and in_ch % 8 == 0)
            hh, ww = (hh + 1) // 2, (ww + 1) // 2  # maxpool 3x3 s2 p1
            res = conv_impl in ("fused", "fused_feat") and fused_resblock.fused_supported(hh, ww)
            self._stages.append(_Stage(feat, res))
            in_ch = ch
        self.flat_features = self.channels[-1] * hh * ww

        f32 = np.float32
        A = self.output_shape
        core_in = self.hidden + 1  # fc output + clipped reward
        core_out = self.hidden if use_lstm else core_in

        # (name, kind, shape-info) in torch registration order
        self._layers = []
        in_ch = c
        for k, ch in enumerate(self.channels):
            self._layers += [
                (f"feat{k}_bn", "bn", in_ch),
                (f"feat{k}_conv", "conv", (ch, in_ch, 3, 3)),
            ]
            in_ch = ch
        for r in (1, 2):
            for k, ch in enumerate(self.channels):
                self._layers += [
                    (f"res{r}_{k}_bn1", "bn", ch),
                    (f"res{r}_{k}_conv1", "conv", (ch, ch, 3, 3)),
                    (f"res{r}_{k}_bn2", "bn", ch),
                    (f"res{r}_{k}_conv2", "conv", (ch, ch, 3, 3)),
                ]
        self._layers += [
            ("fc_bn", "bn", self.flat_features),
            ("fc", "linear", (self.hidden, self.flat_features)),
        ]
        if use_lstm:
            self._layers += [("lstm", "lstm", (core_in, self.hidden))]
        self._layers += [
            ("policy_bn", "bn", core_out),
            ("policy", "linear", (A, core_out)),
        ]

        param_entries, state_entries = [], []
        for name, kind, info in self._layers:
            if kind == "bn":
                param_entries += [((name, "w"), (info,), f32), ((name, "b"), (info,), f32)]
                state_entries += [
                    ((name, "w"), (info,), f32),
                    ((name, "b"), (info,), f32),
                    ((name, "mean"), (info,), f32),
                    ((name, "var"), (info,), f32),
                    ((name, "n"), (), f32),
                ]
            elif kind in ("conv", "linear"):
                out_dim = info[0]
                param_entries += [((name, "w"), info, f32), ((name, "b"), (out_dim,), f32)]
                state_entries += [((name, "w"), info, f32), ((name, "b"), (out_dim,), f32)]
            elif kind == "lstm":
                ci, hdim = info
                shapes = [
                    (("lstm", "w_ih"), (4 * hdim, ci), f32),
                    (("lstm", "w_hh"), (4 * hdim, hdim), f32),
                    (("lstm", "b_ih"), (4 * hdim,), f32),
                    (("lstm", "b_hh"), (4 * hdim,), f32),
                ]
                param_entries += shapes
                state_entries += shapes
        self.param_spec = FlatSpec.make(param_entries)
        self.state_spec = FlatSpec.make(state_entries)

    # -- init: torch defaults, the JAX model's numpy draws -------------------------

    def init(self, seed: int) -> Tuple[Params, State]:
        rng = np.random.RandomState(seed)
        params: Params = {}
        state: State = {}
        for name, kind, info in self._layers:
            if kind == "bn":
                params[name] = {"w": np.ones(info, np.float32), "b": np.zeros(info, np.float32)}
                state[name] = {
                    "mean": np.zeros(info, np.float32),
                    "var": np.ones(info, np.float32),
                    "n": np.zeros((), np.float32),
                }
            elif kind in ("conv", "linear"):
                fan_in = int(np.prod(info[1:]))
                bound = 1.0 / np.sqrt(fan_in)
                params[name] = {
                    "w": rng.uniform(-bound, bound, info).astype(np.float32),
                    "b": rng.uniform(-bound, bound, info[0]).astype(np.float32),
                }
            elif kind == "lstm":
                ci, hdim = info
                k = 1.0 / np.sqrt(hdim)
                params["lstm"] = {
                    "w_ih": rng.uniform(-k, k, (4 * hdim, ci)).astype(np.float32),
                    "w_hh": rng.uniform(-k, k, (4 * hdim, hdim)).astype(np.float32),
                    "b_ih": rng.uniform(-k, k, 4 * hdim).astype(np.float32),
                    "b_hh": rng.uniform(-k, k, 4 * hdim).astype(np.float32),
                }
        to = lambda tree: {k: {n: torch.as_tensor(v, device=self.device) for n, v in d.items()}
                           for k, d in tree.items()}
        return to(params), to(state)

    # -- forward pieces ----------------------------------------------------------------

    def prepare(self, params: Params, state: State) -> Params:
        """``params`` plus the fused kernels' weight layouts (per member:
        the tap-order reorder and the BN fold), computed once."""
        fused = {}
        for k, stage in enumerate(self._stages):
            if stage.feat_fused:
                fused[("feat", k)] = fused_resblock.feat_weights(params, state, k, layers.BN_EPS)
            if stage.res_fused:
                fused[("res", k)] = fused_resblock.stage_weights(params, state, k, layers.BN_EPS)
        return dict(params, **{_PREPARED: fused})

    def _torso(self, params, state, frames: torch.Tensor) -> torch.Tensor:
        """frames [M, N, C, H, W] (raw pixels) -> features [M, N, hidden]:
        the conv blocks (the span ``torso``, counting the call's frames and
        members), then :meth:`_fc`."""
        M, N = frames.shape[:2]
        blocks = self._blocks_nhwc if self.conv_impl == "nhwc" else self._blocks
        with span("torso", frames=M * N, members=M):
            x = blocks(params, state, frames)
        return self._fc(params, state, x)

    def _blocks(self, params, state, frames: torch.Tensor) -> torch.Tensor:
        """frames [M, N, C, H, W] (raw pixels) -> the last stage's output
        [M, N, C', H', W']."""
        if _PREPARED not in params:
            params = self.prepare(params, state)
        fused = params[_PREPARED]
        cd = self.compute_dtype
        x = frames.to(torch.float32) / 255.0
        for k, stage in enumerate(self._stages):
            if stage.feat_fused:
                x = fused_resblock.fused_feat_pool(x, *fused[("feat", k)], compute_dtype=cd)
            else:
                x = batchnorm2d_eval(params[f"feat{k}_bn"], state[f"feat{k}_bn"], x)
                x = self._conv(params[f"feat{k}_conv"], x, cd)
                x = maxpool3x3s2(x)
            if stage.res_fused:
                x = fused_resblock.fused_res_stage(x, *fused[("res", k)], compute_dtype=cd)
                continue
            for r in (1, 2):
                res = x
                y = batchnorm2d_eval(params[f"res{r}_{k}_bn1"], state[f"res{r}_{k}_bn1"], x)
                y = torch.relu(y)
                y = self._conv(params[f"res{r}_{k}_conv1"], y, cd)
                y = batchnorm2d_eval(params[f"res{r}_{k}_bn2"], state[f"res{r}_{k}_bn2"], y)
                y = torch.relu(y)
                y = self._conv(params[f"res{r}_{k}_conv2"], y, cd)
                x = y + res
        return x

    def _blocks_nhwc(self, params, state, frames: torch.Tensor) -> torch.Tensor:
        """The same blocks in channels-last layout: one transpose in, one
        back to [M, N, C, H, W] before the flatten (the fc weights' order)."""
        cd = self.compute_dtype
        x = frames.to(torch.float32).permute(0, 1, 3, 4, 2) / 255.0
        bn = lambda name, v: _batchnorm_nhwc(params[name], state[name], v)
        for k in range(len(self.channels)):
            x = bn(f"feat{k}_bn", x)
            x = conv3x3_nhwc(params[f"feat{k}_conv"], x, cd)
            x = maxpool3x3s2_nhwc(x)
            for r in (1, 2):
                res = x
                y = torch.relu(bn(f"res{r}_{k}_bn1", x))
                y = conv3x3_nhwc(params[f"res{r}_{k}_conv1"], y, cd)
                y = torch.relu(bn(f"res{r}_{k}_bn2", y))
                y = conv3x3_nhwc(params[f"res{r}_{k}_conv2"], y, cd)
                x = y + res
        return x.permute(0, 1, 4, 2, 3)

    def _fc(self, params, state, x: torch.Tensor) -> torch.Tensor:
        """The torso's end (the span ``fc``): ReLU, flatten, BN, fc, ReLU;
        x [M, N, C, H, W]."""
        with span("fc", after="torso"):
            x = torch.relu(x)
            x = x.reshape(x.shape[0], x.shape[1], -1)
            x = layers.batchnorm_eval(params["fc_bn"], state["fc_bn"], x)
            x = layers.linear(params["fc"], x, compute_dtype=self.compute_dtype)
            return torch.relu(x)

    def _head(self, params, state, core_output: torch.Tensor) -> torch.Tensor:
        x = layers.batchnorm_eval(params["policy_bn"], state["policy_bn"], core_output)
        return layers.softmax(layers.linear(params["policy"], x))

    def _members(self, params) -> int:
        return params["fc"]["w"].shape[0]

    def initial_carry(self, M: int):
        if not self.use_lstm:
            return ()
        zero = lambda: torch.zeros((M, self.hidden), dtype=torch.float32, device=self.device)
        return (zero(), zero())

    @staticmethod
    def _core_input(feats: torch.Tensor, rewards: torch.Tensor) -> torch.Tensor:
        """The core's input: feats [..., hidden] with the rewards [...]
        clipped to [-1, 1] appended."""
        clipped = torch.clamp(rewards, -1.0, 1.0).to(torch.float32)
        return torch.cat([feats, clipped[..., None]], dim=-1)

    def _core(self, params, feats: torch.Tensor, rewards: torch.Tensor, carry):
        """LSTM over the time axis of feats [M, T, hidden] with the clipped
        rewards [M, T] appended; carry (h, c) [M, hidden].  Returns
        (core outputs [M, T, *], carry)."""
        core_in = self._core_input(feats, rewards)
        if not self.use_lstm:
            return core_in, carry
        h, c = (v[:, None] for v in carry)
        hs = []
        for t in range(core_in.shape[1]):
            out, (h, c) = layers.lstm_step(params["lstm"], core_in[:, t:t + 1], (h, c))
            hs.append(out)
        return torch.cat(hs, dim=1), (h[:, 0], c[:, 0])

    def step_probs(self, params, state, frame: torch.Tensor, prev_reward: torch.Tensor, carry):
        """One timestep of each member on one frame, the host policy's step:
        frame [M, C, H, W], prev_reward [M] (read clipped), carry (h, c)
        [M, hidden] -> (probs [M, A], carry)."""
        core = self._core_input(self._torso(params, state, frame[:, None])[:, 0], prev_reward)
        if self.use_lstm:
            h, (hh, cc) = layers.lstm_step(params["lstm"], core[:, None],
                                           tuple(v[:, None] for v in carry))
            core, carry = h[:, 0], (hh[:, 0], cc[:, 0])
        return self._head(params, state, core[:, None])[:, 0], carry

    def act_step(self, params, state, obs, prev_reward, prev_done, carry, deterministic, gumbel):
        """One step of E episodes of every member: obs [M, E, C, H, W] (a
        member's episodes are the frames of its torso call), prev_reward
        [M, E] (the LSTM reads it clipped), carry (h, c) [M, E, hidden];
        ``prev_done`` is not read (a done episode's carry is frozen by the
        rollout).  The LSTM, the head and the sample are the span ``core``."""
        feats = self._torso(params, state, obs)
        with span("core", after="fc"):
            core_out = self._core_input(feats, prev_reward)
            if self.use_lstm:
                core_out, carry = layers.lstm_step(params["lstm"], core_out, carry)
            probs = self._head(params, state, core_out)
            action, entropy = sample_action(probs, deterministic, gumbel)
        return action, entropy, carry

    def apply_seq(self, params, state, frames: torch.Tensor, rewards: torch.Tensor) -> torch.Tensor:
        """Whole-sequence probs [M, T, A]: the torso batched over T, the LSTM
        stepped over it from a zero carry.  frames [M, T, C, H, W], rewards
        [M, T]."""
        feats = self._torso(params, state, frames)
        core_out, _ = self._core(params, feats, rewards, self.initial_carry(feats.shape[0]))
        return self._head(params, state, core_out)

    def apply(self, params, state, x: torch.Tensor) -> torch.Tensor:
        """A batch of frames read as a time sequence with zero rewards (the
        shape the strategy and entropy paths need): x [C, H, W], [N, C, H, W]
        shared by the members, or [M, N, C, H, W] -> probs [M, N, A]."""
        M = self._members(params)
        frames = x.to(torch.float32)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.ndim == 4:
            frames = frames.expand(M, *frames.shape)
        rewards = torch.zeros(frames.shape[:2], dtype=torch.float32, device=frames.device)
        return self.apply_seq(params, state, frames, rewards)

    def entropy(self, params, state, xs) -> torch.Tensor:
        return layers.categorical_entropy(self.apply(params, state, xs)).mean(dim=-1)

    def strategy(self, params, state, zeta) -> torch.Tensor:
        return self.apply(params, state, zeta)

    def vbn(self, params, state, buffer: torch.Tensor, rewards=None) -> State:
        """The VBN refresh: one train-mode forward over ``buffer`` [N, C, H,
        W] (raw pixels) at the weights of ``params``, a population of one,
        refreshes every BatchNorm's statistics (the feature and residual
        BNs, ``fc_bn`` and ``policy_bn``), each BN seeing the train-mode
        activations of the layers before it, as the JAX model's ``vbn``.

        As there, the buffer is read as one sequence (the reference's
        batch-first LSTM quirk): the LSTM runs over all N frames from a zero
        carry with ``rewards`` [N] (zeros when None), clipped, appended.
        Also as there, every conv is the float32 unfused conv of
        ``conv_impl`` (the patches conv for ``patches``, ``nhwc`` and the
        fused routes) and neither the convs nor ``fc`` round to
        ``compute_dtype``; train-mode BN cannot be folded into the fused
        kernels, so none launches here."""
        new_state = dict(state)

        def bn2d(name, x):
            y, new_state[name] = batchnorm2d_train(params[name], state[name], x)
            return y

        x = buffer.to(torch.float32)[None] / 255.0
        n = x.shape[1]
        for k in range(len(self.channels)):
            x = bn2d(f"feat{k}_bn", x)
            x = maxpool3x3s2(self._conv(params[f"feat{k}_conv"], x))
            for r in (1, 2):
                res = x
                y = torch.relu(bn2d(f"res{r}_{k}_bn1", x))
                y = self._conv(params[f"res{r}_{k}_conv1"], y)
                y = torch.relu(bn2d(f"res{r}_{k}_bn2", y))
                y = self._conv(params[f"res{r}_{k}_conv2"], y)
                x = y + res
        x = torch.relu(x).reshape(1, n, -1)
        y, new_state["fc_bn"] = layers.batchnorm_train(params["fc_bn"], state["fc_bn"], x)
        feats = torch.relu(layers.linear(params["fc"], y))
        if rewards is None:
            rewards = torch.zeros(n, dtype=torch.float32, device=feats.device)
        core_out, _ = self._core(params, feats, rewards[None], self.initial_carry(1))
        _, new_state["policy_bn"] = layers.batchnorm_train(
            params["policy_bn"], state["policy_bn"], core_out)
        return new_state

    # -- full-state (wire) view --------------------------------------------------

    def _merge_full(self, params, state):
        merged = {}
        for name, kind, _ in self._layers:
            merged[name] = dict(params[name])
            if kind == "bn":
                merged[name].update(state[name])
        return merged

    def _split_full(self, merged):
        params, state = {}, {}
        for name, kind, _ in self._layers:
            if kind == "bn":
                params[name] = {"w": merged[name]["w"], "b": merged[name]["b"]}
                state[name] = {k: merged[name][k] for k in ("mean", "var", "n")}
            else:
                params[name] = dict(merged[name])
        return params, state

    # -- reference-construction metadata -----------------------------------------

    def reference_module_specs(self):
        """torch modules that draw RNG during reference construction, in
        *construction* order (impala.py:62-111: per channel block the feature
        conv, then the two residual sub-blocks' convs — interleaved, unlike
        the registration order used by the flat views)."""
        specs, names = [], []
        in_ch = self.input_shape[0]
        for k, ch in enumerate(self.channels):
            specs.append(("conv2d", in_ch, ch, 3, 3))
            names.append(f"feat{k}_conv")
            for r in (1, 2):
                specs += [("conv2d", ch, ch, 3, 3), ("conv2d", ch, ch, 3, 3)]
                names += [f"res{r}_{k}_conv1", f"res{r}_{k}_conv2"]
            in_ch = ch
        specs.append(("linear", self.flat_features, self.hidden))
        names.append("fc")
        if self.use_lstm:
            specs.append(("lstm", self.hidden + 1, self.hidden))
            names.append("lstm")
        specs.append(("linear", self.hidden, self.output_shape))
        names.append("policy")
        self._construction_names = names
        return specs

    def reference_construction_names(self):
        self.reference_module_specs()
        return self._construction_names
