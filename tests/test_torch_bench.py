"""The port's throughput benchmark (``dfd_tpu_torch/bench.py``, ``python -m
dfd_tpu_torch bench``) held against the JAX package's ``bench.py`` on the
CPU: its six cells field for field (``bench.py``'s own cells recorded
through a stand-in ``bench_config``, so no JAX epoch runs), the env-steps
it counts against JAX's on the same draws, its JSON line, and the mesh
harness over two gloo processes.
"""

import contextlib
import dataclasses
import io
import json
import re

import numpy as np
import pytest
import torch

import bench as jax_bench
from _torch_port import jax_epoch_draws, jax_state_numpy
from dfd_tpu.config import TrainConfig as JaxTrainConfig
from dfd_tpu.envs.trap import TrapEnv as JaxTrapEnv
from dfd_tpu.models import DiscreteMLP as JaxDiscreteMLP
from dfd_tpu.ops import distances as jax_distances
from dfd_tpu.runners import VectorizedTrainer as JaxTrainer
from dfd_tpu_torch import bench
from dfd_tpu_torch.__main__ import main
from dfd_tpu_torch.convert import train_state_from_numpy
from dfd_tpu_torch.envs import TrapEnv
from dfd_tpu_torch.runners import VectorizedTrainer

CPU = "cpu"
TPU_TARGET_FIELDS = {"suite_vs_per_chip_target", "suite_x8_chips_extrapolated",
                     "suite_x8_vs_1M_aggregate"}
NUM_PARAMS = {"mlp_trap": 5197, "mlp_trap_e8": 5197, "gaussian_swimmer": 6028,
              "cnn_pixelgrid": 308_373, "impala_procmaze": 1_156_139,
              "impala_prod_bf16": 7_872_651}
STEPS = re.compile(r"\[bench:(\S+)\] (\d+) env-steps in ")


@pytest.fixture(scope="module")
def jax_cells():
    """``bench.py``'s ``main`` with ``bench_config`` replaced by a recorder:
    (each cell's (name, model, env, distance_fn, cfg, n_epochs, mesh), its
    JSON line)."""
    calls = []

    def record(name, model, env, distance_fn, cfg, n_epochs, mesh=None):
        calls.append((name, model, env, distance_fn, cfg, n_epochs, mesh))
        return 1.0

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(jax_bench, "bench_config", record)
        jax_bench.main()
    return calls, json.loads(out.getvalue().strip().splitlines()[-1])


def _dtype(x):
    """A compute dtype's name (``jnp.bfloat16`` and ``torch.bfloat16`` alike), or None."""
    return None if x is None else re.sub(r"\W", "", str(x).rsplit(".", 1)[-1])


def _scalars(obj) -> dict:
    """``obj``'s public attributes that are numbers, strings or tuples."""
    out = {k: v for k, v in vars(obj).items() if not k.startswith("_")
           and isinstance(v, (int, float, bool, str, tuple, type(None)))}
    if "compute_dtype" in vars(obj):
        out["compute_dtype"] = _dtype(obj.compute_dtype)
    return out


def _same_scalars(got, want, needed):
    """Every public scalar the two objects' instances share is equal, and so
    are the ``needed`` attributes (an instance's or its class's)."""
    g, w = _scalars(got), _scalars(want)
    shared = set(g) & set(w)
    assert {k: g[k] for k in shared} == {k: w[k] for k in shared}
    assert {k: getattr(got, k) for k in needed} == {k: getattr(want, k) for k in needed}


def test_cells_are_bench_py_in_order(jax_cells):
    calls, _ = jax_cells
    assert [(c.name, c.n_epochs) for c in bench.CELLS] == [(c[0], c[5]) for c in calls]
    assert [c.n_epochs for c in bench.CELLS] == [30, 12, 10, 10, 10, 6]
    assert all(c[6] is None for c in calls)  # no mesh


@pytest.mark.parametrize("i, name", list(enumerate(NUM_PARAMS)))
def test_cell_is_bench_py_field_for_field(i, name, jax_cells):
    """The cell's TrainConfig, model (class, widths, compute dtype,
    conv_impl, num_params), env (class and parameters) and distance
    function are bench.py's."""
    _, jmodel, jenv, jdist, jcfg, _, _ = jax_cells[0][i]
    cell = bench.CELLS[i]
    model, env, dist, cfg = cell.build(CPU)
    assert cell.name == name
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert type(model).__name__ == type(jmodel).__name__
    assert model.num_params == jmodel.num_params == NUM_PARAMS[name]
    _same_scalars(model, jmodel, ("input_shape", "output_shape"))
    if hasattr(jmodel, "conv_impl"):
        _same_scalars(model, jmodel, ("channels", "hidden", "conv_impl"))
    if hasattr(jmodel, "compute_dtype"):
        assert _dtype(model.compute_dtype) == _dtype(jmodel.compute_dtype)
    assert type(env).__name__ == type(jenv).__name__
    _same_scalars(env, jenv, ("obs_shape", "max_episode_steps"))
    assert dist.__name__ == jdist.__name__
    assert str(model.device) == str(env.device) == CPU


SMALL = dict(batch_size=8, learning_rate=0.05, noise_std=0.05, zeta_size=4,
             max_strategy_history_size=4, random_seed=0, scan_unroll=8)


def _steps(err: str) -> dict:
    return {name: int(n) for name, n in STEPS.findall(err)}


def test_bench_counts_the_env_steps_jax_counts(monkeypatch, capsys):
    """A small trap config (P = 8, zeta 4, history 4), 2 timed epochs after
    the warm one, through both packages' ``bench_config``; the port on the
    JAX trainer's own draws and initial state: equal step counts, which are
    the full 201-step episodes of the P members and the eval member."""
    args = (jax_distances.categorical_tvd, JaxTrainConfig(**SMALL))
    jax_bench.bench_config("small", JaxDiscreteMLP(2, 9), JaxTrapEnv(), *args, n_epochs=2)
    want = _steps(capsys.readouterr().err)["small"]

    # the JAX trainer's key chain, its epochs chained as bench_config chains them
    jtr = JaxTrainer(JaxDiscreteMLP(2, 9), JaxTrapEnv(), *args)
    init = train_state_from_numpy(jax_state_numpy(jtr.state), CPU)
    archive, count = jtr._archive_inputs()
    assert count == 0
    draws = {}
    for epoch in range(3):
        draws[epoch] = jax_epoch_draws(jtr, TrapEnv(device=CPU))
        jtr.state, _ = jtr._step(jtr.state, archive, count)

    class OnJaxDraws(VectorizedTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, draw_source=draws.__getitem__, **kw)
            self.state = init

    monkeypatch.setattr(bench, "VectorizedTrainer", OnJaxDraws)
    rate = bench.bench_config("small", *bench.mlp_trap(CPU, **SMALL), n_epochs=2, device=CPU)
    got = _steps(capsys.readouterr().err)["small"]
    assert got == want == 2 * (8 + 1) * 201
    assert rate > 0 and np.isfinite(rate)


def _tiny_cells():
    tiny = dict(batch_size=4, zeta_size=4, max_strategy_history_size=4)
    return (bench.Cell("mlp_trap", 1, lambda d: bench.mlp_trap(d, **tiny)),
            bench.Cell("mlp_trap_e2", 2,
                       lambda d: bench.mlp_trap(d, envs_per_perturbation=2, **tiny)))


def test_bench_prints_jax_json_line_without_tpu_targets(monkeypatch, capsys, jax_cells):
    """``bench --device cpu`` on two tiny cells: the last stdout line is one
    JSON object with bench.py's keys less its three TPU-target fields, plus
    the device; ``value`` is the ``mlp_trap`` rate, ``vs_baseline`` null."""
    monkeypatch.setattr(bench, "CELLS", _tiny_cells())
    assert main(["bench", "--device", CPU]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == (set(jax_cells[1]) - TPU_TARGET_FIELDS) | {"device"}
    assert line["metric"] == jax_cells[1]["metric"] == "fd_eval_env_steps_per_s_single_chip"
    assert line["unit"] == "env-steps/s" and line["vs_baseline"] is None
    assert line["device"] == CPU
    assert list(line["suite"]) == ["mlp_trap", "mlp_trap_e2"]
    assert line["value"] == line["suite"]["mlp_trap"] > 0
    # 4 members and the eval member, 201 steps each; E = 2 counts both episodes a member
    assert _steps(err) == {"mlp_trap": 5 * 201, "mlp_trap_e2": 2 * (4 * 2 + 1) * 201}


def test_mesh_harness_counts_rank_zero_over_two_gloo_processes(capsys):
    """``main_mesh(2)``: n = 1 in this process, n = 2 over two gloo
    processes.  At n = 1 the count is the formula (P + 1) x 201 an epoch
    (every trap episode runs its 201 steps); at n = 2 it is the formula at
    P = 16, rank 0's count of the whole population, not the ranks' sum."""
    line = bench.main_mesh(2, base_p=8, n_epochs=1, device=CPU, timeout=240)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert line["metric"] == "fd_eval_mesh_harness_steps_per_s_2dev"
    assert list(line["suite"]) == ["steps_per_s_1dev", "steps_per_s_2dev"]
    assert line["value"] == line["suite"]["steps_per_s_2dev"] > 0
    assert "gloo processes on the CPU" in line["unit"] and line["vs_baseline"] is None
    steps = _steps(err)
    assert steps["mesh1"] == (8 + 1) * 201
    assert steps["mesh2"] == (16 + 1) * 201


def test_bench_cli_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    """``python -m dfd_tpu_torch.bench [--mesh N]`` without a card: the
    default ``--device cuda`` refuses with resolve_device's message and rc 2,
    the six cells and the mesh harness alike; ``--mesh 2 --device cpu``
    hands the harness the CPU."""
    calls = []
    monkeypatch.setattr(bench, "main_mesh", lambda n, **kw: calls.append((n, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--mesh", "2"], ["--mesh", "2", "--device", "cuda"]):
        assert bench.cli(argv) == 2
        assert "no CUDA device is available" in capsys.readouterr().err
    assert calls == []
    assert bench.cli(["--mesh", "2", "--device", CPU]) == 0
    assert calls == [(2, {"device": torch.device(CPU)})]
