"""The port's launchers (``deploy/torch/``), read on the CPU: no job is
submitted and no image is built (a build downloads).

* each SLURM script's ``srun`` line starts ``train_mask_bev_torch.py`` and
  parses with its argument parser (the script's variables given values);
  the job runs one task a card (``--gpus-per-task=1``) and names task 0 as
  ``MASKBEV_COORDINATOR``, which the port reads with SLURM's task
  variables; the scripts pass ``bash -n``;
* a SLURM task bound to one card takes ``cuda:0`` whatever its
  ``SLURM_LOCALID`` (``parallel/distributed.py::local_rank``);
* the Dockerfile builds from a public CUDA devel image (nvcc for the
  kernels) and its entry point, like the compose service's, is
  ``train_mask_bev_torch.py``; the service reserves NVIDIA cards.
"""
import importlib.util
import pathlib
import re
import shlex
import subprocess

import pytest

torch = pytest.importorskip("torch")

import yaml  # noqa: E402

from mask_bev_tpu_torch.parallel import distributed  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEPLOY = ROOT / "deploy" / "torch"


def _cli():
    spec = importlib.util.spec_from_file_location(
        "train_mask_bev_torch_cli", ROOT / "train_mask_bev_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script,flag", [("slurm_train.sh", "train"),
                                         ("slurm_test.sh", "test")])
def test_slurm_srun_line_parses(script, flag):
    text = (DEPLOY / script).read_text()
    subprocess.run(["bash", "-n", str(DEPLOY / script)], check=True)
    sbatch = dict(re.findall(r"^#SBATCH --([\w-]+)=(\S+)", text, re.M))
    assert sbatch["gpus-per-task"] == "1"
    assert int(sbatch["ntasks-per-node"]) >= 1
    assert re.search(r"^export MASKBEV_COORDINATOR=", text, re.M)
    (line,) = [ln for ln in text.splitlines() if ln.startswith("srun ")]
    line = line.replace('"$CONFIG"', "configs/training/semantic_kitti/"
                        "01_semantic_kitti.yml").replace('"$DATA_ROOT"',
                                                         "data")
    argv = shlex.split(line)
    assert argv[:3] == ["srun", "python", "train_mask_bev_torch.py"]
    args = _cli().build_parser().parse_args(argv[3:])
    assert getattr(args, flag) and not getattr(args, {"train": "test",
                                                      "test": "train"}[flag])
    assert args.device == "cuda" and args.data_root == "data"
    assert (ROOT / args.config).exists()


def test_slurm_task_takes_its_bound_card(monkeypatch):
    """Under ``--gpus-per-task=1`` a task sees its own card alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    for localid in ("0", "3", "7"):
        monkeypatch.setenv("SLURM_LOCALID", localid)
        assert distributed.local_rank() == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert distributed.local_rank() == 7  # every card visible


def test_docker_files_start_the_port():
    docker = (DEPLOY / "Dockerfile").read_text()
    (base,) = re.findall(r"^FROM (\S+)", docker, re.M)
    assert base.startswith("nvidia/cuda:") and "devel" in base
    assert re.search(r'^ENTRYPOINT \["python", "train_mask_bev_torch.py"\]',
                     docker, re.M)
    assert "mask_bev_tpu_torch" in docker and "jax" not in docker.lower()
    compose = yaml.safe_load((DEPLOY / "docker-compose.yml").read_text())
    svc = compose["services"]["training"]
    assert svc["build"]["dockerfile"] == "deploy/torch/Dockerfile"
    assert (DEPLOY / svc["build"]["context"] / "train_mask_bev_torch.py"
            ).resolve().exists()
    assert svc["entrypoint"] == ["python", "train_mask_bev_torch.py"]
    (dev,) = svc["deploy"]["resources"]["reservations"]["devices"]
    assert dev["driver"] == "nvidia" and "gpu" in dev["capabilities"]
