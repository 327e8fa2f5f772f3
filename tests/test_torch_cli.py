"""The port's command line (``python -m dfd_tpu_torch``) on the CPU
(``--device cpu``), the cases of ``tests/test_cli.py`` that this port
covers, plus its factory against the JAX package's, the ``server`` and
``client`` subcommands' flags (JAX's plus ``--device``) and what they hand
their runners, the default device's refusal without a card, and the
installed port's console script.

The sequential topology's playback files are byte-equal to the JAX CLI's
for the same seed: its action streams are the same
(``tests/test_torch_sequential.py``).
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dfd_tpu.__main__ import main as jax_main
from dfd_tpu.utils import factory as jfactory
from dfd_tpu_torch.__main__ import main
from dfd_tpu_torch.utils import factory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--batch-size", "4", "--zeta-size", "8", "--history-size", "4", "--quiet"]
CPU = ["--device", "cpu"]


def test_cli_train_vectorized(tmp_path, capsys):
    ckpt = str(tmp_path / "c.npz")
    rc = main(["train", "--env", "SimpleTrapEnv-v0", "--epochs", "2", *SMALL, *CPU,
               "--checkpoint", ckpt])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Noisy Reward" in out and "'Epoch': 2" in out
    assert os.path.exists(ckpt)


def test_cli_train_resume(tmp_path, capsys):
    ckpt = str(tmp_path / "c.npz")
    main(["train", "--env", "SimpleTrapEnv-v0", "--epochs", "1", *SMALL, *CPU,
          "--checkpoint", ckpt])
    rc = main(["train", "--env", "SimpleTrapEnv-v0", "--epochs", "1", *SMALL, *CPU,
               "--resume", ckpt])
    assert rc == 0
    assert "'Epoch': 2" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_cli_train_fast_on_each_noise_backend(backend, capsys):
    rc = main(["train", "--env", "SimpleTrapEnv-v0", "--epochs", "2", "--fast",
               "--sync-every", "1", "--noise-backend", backend, "--unroll", "4", *SMALL, *CPU])
    assert rc == 0
    assert "'Epoch': 2" in capsys.readouterr().out


def test_cli_train_sequential(capsys):
    rc = main(["train", "--topology", "sequential", "--env", "SimpleTrapEnv-v0", "--epochs", "1",
               "--batch-size", "3", "--zeta-size", "6", "--history-size", "4", *CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Begin Epoch Report" in out and "Update Magnitude" in out


def test_cli_sweep(capsys):
    rc = main(["sweep", "--env", "SimpleTrapEnv-v0", "--trials", "2", "--epochs", "2",
               "--batch-size", "4", "--zeta-size", "8", "--history-size", "4", *CPU])
    assert rc == 0
    assert "best:" in capsys.readouterr().out


def test_cli_antithetic_requires_vectorized(capsys):
    rc = main(["train", "--topology", "sequential", "--env", "SimpleTrapEnv-v0", "--epochs", "1",
               *SMALL, *CPU, "--antithetic"])
    assert rc == 2
    assert "antithetic" in capsys.readouterr().err


def test_cli_playback_requires_sequential(capsys):
    rc = main(["train", "--env", "SimpleTrapEnv-v0", "--epochs", "1", *SMALL, *CPU,
               "--playback-id", "x"])
    assert rc == 2
    assert "playback" in capsys.readouterr().err


def test_cli_playback_files_are_byte_equal_to_jax(tmp_path, monkeypatch):
    args = ["train", "--topology", "sequential", "--env", "SimpleTrapEnv-v0", "--epochs", "1",
            "--batch-size", "3", "--zeta-size", "8", "--history-size", "4", "--quiet",
            "--playback-id", "cli_worker"]
    files = []
    for run, extra, sub in ((jax_main, [], "jax"), (main, CPU, "port")):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert run(args + extra) == 0
        path = tmp_path / sub / "data" / "custom_novelty_playbacks" / "in_progress" / \
            "cli_worker.txt"
        files.append(path.read_bytes())
    assert files[1] == files[0]
    lines = files[1].decode().splitlines()
    assert len(lines) >= 3 and all(len(line.split()) == 200 for line in lines)


def test_cli_profile_dir_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "trace"
    rc = main(["train", "--env", "SimpleTrapEnv-v0", "--epochs", "3", *SMALL, *CPU,
               "--profile-dir", str(prof), "--profile-epochs", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "profile: traced 1 epoch(s)" in out
    assert "'Epoch': 3" in out  # profiling must not eat epochs
    assert (prof / "trace.json").stat().st_size > 0


def test_cli_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "dfd_tpu_torch", "train", "--topology", "sequential",
         "--epochs", "1", "--batch-size", "2", "--zeta-size", "4", "--history-size", "4",
         "--quiet", *CPU],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr


def test_cli_default_device_fails_without_a_card(monkeypatch, capsys):
    """No card: the default ``--device cuda`` refuses, with resolve_device's
    message and rc 2, rather than training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["train", "--epochs", "1", *SMALL],
                 ["train", "--topology", "sequential", "--epochs", "1", *SMALL],
                 ["sweep", "--trials", "1", "--epochs", "1"],
                 ["bench"]):
        assert main(argv) == 2
        assert "no CUDA device is available" in capsys.readouterr().err


def test_installed_script_resolves_to_the_port_main():
    """``pyproject.toml``'s ``dfd-tpu-torch`` console script is the port's
    ``main``, beside JAX's ``dfd-tpu``; the port's ``_native`` copy of the
    env pool is package data; the version is ``version.py``'s."""
    import tomllib

    import dfd_tpu_torch
    from dfd_tpu_torch import version

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    scripts = project["project"]["scripts"]
    assert scripts["dfd-tpu"] == "dfd_tpu.__main__:main"
    module, attr = scripts["dfd-tpu-torch"].split(":")
    assert getattr(importlib.import_module(module), attr) is main
    data = project["tool"]["setuptools"]["package-data"]
    assert data["dfd_tpu_torch._native"] == ["*.so"]
    assert importlib.import_module("dfd_tpu_torch._native").__file__
    assert dfd_tpu_torch.__version__ == version.__version__


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_cli_train_mesh_without_torchrun_is_a_mesh_of_one(backend, tmp_path, capsys,
                                                          monkeypatch):
    """``train --mesh`` outside torchrun (no WORLD_SIZE): a mesh of one,
    the same report as without ``--mesh``, and the checkpoint written.  Two
    ranks under a torchrun-style launch: ``tests/test_torch_parallel.py``."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["train", "--env", "SimpleTrapEnv-v0", "--epochs", "2", "--noise-backend", backend,
            *SMALL, *CPU]
    reports = []
    for extra in ([], ["--mesh", "--checkpoint", str(tmp_path / "c.npz")]):
        assert main(argv + extra) == 0
        reports.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert reports[0] == reports[1] and "'Epoch': 2" in reports[0]
    assert os.path.exists(tmp_path / "c.npz")


def test_cli_client_slice_mesh_hands_a_mesh_of_one(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(importlib.import_module("dfd_tpu_torch.runners.slice_client"),
                        "SliceClientRunner", _Recorder)
    _Recorder.calls = []
    assert main(["client", "--mode", "slice", "--mesh", "--n-envs", "6", *CPU]) == 0
    (_, kw), (what, _) = _Recorder.calls
    mesh = kw["mesh"]
    assert (mesh.rank, mesh.size, str(mesh.device), what) == (0, 1, "cpu", "run")


def _flags(entry, cmd, capsys):
    """The option strings of ``entry``'s ``cmd`` subcommand, from its help."""
    import re

    with pytest.raises(SystemExit):
        entry([cmd, "--help"])
    return set(re.findall(r"(?<![\w-])(--[a-z][a-z-]*)", capsys.readouterr().out)) - {"--help"}


@pytest.mark.parametrize("cmd", ["server", "client"])
def test_cli_server_and_client_have_jax_flags_plus_device(cmd, capsys):
    assert _flags(main, cmd, capsys) == _flags(jax_main, cmd, capsys) | {"--device"}


class _Recorder:
    """A stand-in runner class: records its constructor's keywords and the
    keywords of its ``train``/``run`` call."""

    calls = []

    def __init__(self, **kw):
        self.calls.append(("init", kw))

    def train(self, **kw):
        self.calls.append(("train", kw))

    def run(self, **kw):
        self.calls.append(("run", kw))
        return True


def test_cli_server_hands_its_flags_to_the_runner(monkeypatch):
    from dfd_tpu_torch.runners import server

    monkeypatch.setattr(server, "ServerRunner", _Recorder)
    _Recorder.calls = []
    assert main(["server", "--env", "Swimmer-v0", "--port", "0", "--batch-size", "7", "--seed",
                 "9", "--lr", "0.5", "--noise-std", "0.25", "--zeta-size", "3",
                 "--history-size", "5", "--normalize-obs", "--timestep-limit", "99",
                 "--address", "127.0.0.1", *CPU]) == 0
    (_, kw), (what, train_kw) = _Recorder.calls
    assert (what, train_kw) == ("train", {})
    assert str(kw.pop("device")) == "cpu"
    kw.pop("reporter")
    assert kw == dict(env_id="Swimmer-v0", learning_rate=0.5, noise_std=0.25, batch_size=7,
                      random_seed=9, zeta_size=3, max_strategy_history_size=5,
                      normalize_obs=True, address="127.0.0.1", port=0, timestep_limit=99)


@pytest.mark.parametrize("mode, module, cls, want", [
    ("thin", "client", "ClientRunner", dict(address="h", port=7)),
    ("fat", "fat_client", "FatClientRunner",
     dict(n_envs=12, address="h", port=7, pipeline_lanes=2, env_backend="thread")),
    ("slice", "slice_client", "SliceClientRunner",
     dict(n_members=12, address="h", port=7, population_chunk=4, mesh=None)),
])
def test_cli_client_hands_its_flags_to_the_runner(mode, module, cls, want, monkeypatch):
    import importlib

    monkeypatch.setattr(importlib.import_module(f"dfd_tpu_torch.runners.{module}"), cls,
                        _Recorder)
    _Recorder.calls = []
    assert main(["client", "--mode", mode, "--address", "h", "--port", "7", "--n-envs", "12",
                 "--max-windows", "3", "--pipeline-lanes", "2", "--env-backend", "thread",
                 "--population-chunk", "4", *CPU]) == 0
    (_, kw), (what, run_kw) = _Recorder.calls
    assert str(kw.pop("device")) == "cpu"
    assert kw == want
    assert (what, run_kw) == ("run", {} if mode == "thin" else {"max_windows": 3})


def test_cli_server_and_client_refuse_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["server"], ["client"], ["client", "--mode", "fat"]):
        assert main(argv) == 2
        assert "no CUDA device is available" in capsys.readouterr().err


def test_factory_takes_the_gym_ids_through_the_adapters():
    """An id outside the native ones goes to the gymnasium adapter (an
    unknown one fails where gymnasium does); the gymnasium, procgen and
    Atari branches are held to JAX's in ``tests/test_torch_gym_adapter.py``
    and ``tests/test_torch_atari_wrappers.py``."""
    from dfd_tpu_torch.envs.gym_adapter import GymnasiumEnv

    env, model, _ = factory.get_init_data("CartPole-v0", 1, "cpu")
    assert isinstance(env, GymnasiumEnv) and model.input_shape == 4 and model.output_shape == 2
    with pytest.raises(Exception, match="CartPole-v0-gym-only"):
        factory.get_init_data("CartPole-v0-gym-only", 1, "cpu")


@pytest.mark.parametrize("env_id", sorted(jfactory.JAX_ENVS) + sorted(jfactory.JAX_PIXEL_ENVS))
def test_factory_matches_jax(env_id):
    """Every registered id: the same model class and parameter count, env
    shapes and distance, in both the host and the vectorized forms; the
    host env resets to JAX's first observation."""
    assert set(factory.JAX_ENVS) == set(jfactory.JAX_ENVS)
    assert set(factory.JAX_PIXEL_ENVS) == set(jfactory.JAX_PIXEL_ENVS)
    jenv, jmodel, jdist = jfactory.get_init_data(env_id, 4)
    penv, pmodel, pdist = factory.get_init_data(env_id, 4, "cpu")
    assert type(pmodel).__name__ == type(jmodel).__name__
    assert pmodel.num_params == jmodel.num_params
    assert pmodel.state_spec.size == jmodel.state_spec.size
    assert pmodel.device.type == "cpu"
    assert pdist.__name__ == jdist.__name__
    assert type(penv).__name__ == type(jenv).__name__
    assert penv.n_actions == jenv.n_actions
    jo, po = jenv.reset(), penv.reset()
    if isinstance(jo, dict):
        jo, po = jo["frame"], po["frame"]
    np.testing.assert_array_equal(po, jo)
    venv, vmodel, _ = factory.get_vectorized_init_data(env_id, "cpu")
    jvenv = jfactory.make_jax_env(env_id)
    assert tuple(venv.obs_shape) == tuple(jvenv.obs_shape)
    assert venv.max_episode_steps == jvenv.max_episode_steps
    assert vmodel.num_params == jmodel.num_params


def test_cli_population_chunk_and_normalize_obs(capsys):
    rc = main(["train", "--env", "SimpleTrapEnv-v0", "--epochs", "2", "--population-chunk", "2",
               "--normalize-obs", *SMALL, *CPU])
    assert rc == 0
    assert "'Epoch': 2" in capsys.readouterr().out
