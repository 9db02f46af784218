"""Import hygiene and device defaults of the PyTorch port.

The port (``src/repro_torch``) and ``chip_smoke.py`` import neither JAX nor
the JAX package ``repro`` (importing any ``repro`` module installs the jax
shims); only the port's tests import both.  Entry points run on the CUDA
device unless the caller asks for the CPU, and raise where there is none.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s)|from\s+\.\.\.+\s+import|"
    r".*__import__\(\s*['\"](jax|repro)(\.|['\"]))", re.M)


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch.apps.pcit, repro_torch.apps.nbody, "
        "repro_torch.core.selfcheck, repro_torch.kernels.ops, "
        "repro_torch.core.sparse, repro_torch.serving, "
        "repro_torch.serving.selfcheck, repro_torch.kernels.query_score, "
        "repro_torch.kernels.pairwise_threshold, repro_torch.core.knn, "
        "repro_torch.core.quant, repro_torch.kernels.pairwise_topk, "
        "repro_torch.kernels.pairwise_batch_q, "
        "repro_torch.kernels.flash_attention, repro_torch.kernels.ssd_chunk, "
        "repro_torch.apps.attention, repro_torch.models.config, "
        "repro_torch.models.common, repro_torch.models.ssm, "
        "repro_torch.models.lm, repro_torch.configs.registry, "
        "repro_torch.configs.mamba2_130m, repro_torch.launch.steps, "
        "repro_torch.launch.serve, repro_torch.serving.batching, "
        "repro_torch.launch.query_serve, repro_torch.core.delta, "
        "repro_torch.core.faults, repro_torch.ckpt.checkpoint, "
        "repro_torch.launch.elastic, repro_torch.obs.comm, "
        "repro_torch.obs.report, repro_torch.obs.feedback, "
        "repro_torch.models.attention, repro_torch.configs.qwen3_14b, "
        "repro_torch.configs.starcoder2_3b, "
        "repro_torch.configs.deepseek_coder_33b, "
        "repro_torch.configs.h2o_danube_1_8b, repro_torch.models.moe, "
        "repro_torch.models.whisper, repro_torch.configs.jamba_v0_1_52b, "
        "repro_torch.configs.llama4_scout_17b_a16e, "
        "repro_torch.configs.llama4_maverick_400b_a17b, "
        "repro_torch.configs.whisper_large_v3, "
        "repro_torch.configs.qwen2_vl_72b, repro_torch.optim, "
        "repro_torch.optim.adamw, repro_torch.optim.compress, "
        "repro_torch.data, repro_torch.data.pipeline, "
        "repro_torch.launch.mesh, repro_torch.launch.train, "
        "repro_torch.launch.dryrun, repro_torch.core.comm, "
        "repro_torch.ckpt.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_dry_run_initialises_no_cuda():
    """The dry run runs on the meta device: it imports neither JAX nor
    the JAX package and leaves CUDA uninitialised."""
    code = (
        "import sys, torch\n"
        "from repro_torch.launch import dryrun\n"
        "rec, = dryrun.main(['--arch', 'mamba2_130m', '--shape', "
        "'train_4k'])\n"
        "assert rec['memory']['argument_bytes'] > 0, rec\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('DRYRUN-OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "DRYRUN-OK" in r.stdout, r.stdout + r.stderr


def test_comm_backend_import_starts_nothing():
    """``core.comm`` with ``DistributedComm`` imports neither JAX nor the
    JAX package, and importing it initialises no process group and no
    CUDA."""
    code = (
        "import sys, torch, torch.distributed as dist\n"
        "from repro_torch.core.comm import DistributedComm\n"
        "assert not dist.is_initialized()\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('COMM-OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "COMM-OK" in r.stdout, r.stdout + r.stderr


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path}: {hits}"


def test_entry_points_default_to_cuda(monkeypatch):
    """device=None means the CUDA device; on a host without one the entry
    points raise instead of running on the CPU."""
    from repro_torch.apps import nbody, pcit
    from repro_torch.core import comm, selfcheck
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comm.SingleProcessComm(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        comm.SingleProcessComm(4, "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comm.DistributedComm("gloo", rank=0, world_size=1,
                             init_method="file:///nonexistent/store")
    with pytest.raises(RuntimeError, match="CUDA"):
        selfcheck.main(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        nbody.distributed_forces(torch.zeros(8, 4), comm.SingleProcessComm(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        pcit.run_quorum_pcit(torch.zeros(8, 4).numpy(),
                             comm.SingleProcessComm(2))
    from repro_torch.core import sparse
    from repro_torch.serving import ServingCorpus
    from repro_torch.serving import selfcheck as serving_selfcheck
    corpus = torch.zeros(8, 4).numpy()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingCorpus.build(corpus, comm.SingleProcessComm(2))
    with pytest.raises(RuntimeError, match="CUDA"):
        sparse.similarity_join(corpus, comm.SingleProcessComm(2),
                               threshold=0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving_selfcheck.main(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        sparse.selfcheck_main(2)
    from repro_torch.core import knn, quant
    with pytest.raises(RuntimeError, match="CUDA"):
        knn.knn_graph(corpus, comm.SingleProcessComm(2), topk=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        knn.selfcheck_main(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        quant.selfcheck_main(2)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve("mamba2_130m", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2_130m", "--smoke"])
    from repro_torch.core import delta, faults
    from repro_torch.launch import query_serve
    from repro_torch.serving import batching
    with pytest.raises(RuntimeError, match="CUDA"):
        batching.main(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        query_serve.main(["--n", "16", "--requests", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        delta._main(["--P", "4", "--modes", "batched"])
    with pytest.raises(RuntimeError, match="CUDA"):
        faults._main(["--P", "5", "--modes", "batched"])
    with pytest.raises(RuntimeError, match="CUDA"):
        faults.DenseReduceWorkload(4)
    from repro_torch.obs import comm as obs_comm, feedback
    with pytest.raises(RuntimeError, match="CUDA"):
        obs_comm._main(["--P", "5"])
    with pytest.raises(RuntimeError, match="CUDA"):
        feedback._main(["--P", "5"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.serve("qwen3_14b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "h2o_danube_1_8b", "--smoke"])
    for arch in ("jamba_v0_1_52b", "llama4_scout_17b_a16e", "qwen2_vl_72b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.serve(arch, smoke=True)
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.launch import mesh, train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train("starcoder2_3b", steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "starcoder2_3b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pipeline(DataConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train("qwen3_14b", steps=1, mesh_spec="data=2,model=2",
                    dist="gloo")
    # the --dist paths (a torchrun rank): DistributedComm.from_env takes
    # the CUDA device too, before any process group starts
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    for main in (sparse.selfcheck_main, knn.selfcheck_main,
                 quant.selfcheck_main, serving_selfcheck.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            comm.run_main(main, 1, dist="gloo")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        query_serve.main(["--n", "16", "--requests", "4", "--P", "1",
                          "--dist", "gloo"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        obs_comm._main(["--P", "1", "--quant", "int8", "--dist", "gloo"])
    assert not torch.distributed.is_initialized()
    assert comm.SingleProcessComm(4, "cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script in (ROOT / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)], env=env,
                           capture_output=True, text=True, timeout=300,
                           cwd=script.parent)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
