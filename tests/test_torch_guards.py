"""Guards on the port's boundaries.

- `monortm_tpu_torch` runs its forward pass and a backward pass through
  it, and its CLI (run as `__main__`) through the pipeline on an IATM=0
  and an IATM=1 rundir, without importing jax or any module of the JAX
  package `monortm_tpu` (the machine with the GPU has no JAX, and the
  port keeps its own copies of the host modules it needs), and neither
  does the envelope entry point (`python -m monortm_tpu_torch.envelope`);
- the pipeline's modules, the mesh modules (`parallel/`) and the
  envelope's among them,
  hold no import of either, read from their source, and two gloo ranks
  that take a gradient on a mesh never import either;
- the CLI on its default device fails where there is no GPU;
- `chip_smoke.py` fails, and prints no result, where there is no GPU;
- importing the kernel module needs neither nvcc nor triton;
- the IATM=1 layering pool's workers never import torch, though their
  parent has it and the CLI's module loaded, whether the parent's
  `__main__` is `-c` or a script that imports torch (the console
  script's case): the pool's count of workers without torch is its
  worker count.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

TINY_FORWARD = """
import sys
import numpy as np
import torch
from monortm_tpu_torch.models.monortm import MonoRTM
from monortm_tpu_torch.testing import synthetic_catalog_mw, synthetic_state
wn = np.linspace(0.3, 55.0, 32)
m = MonoRTM(wn, float(wn[1] - wn[0]), synthetic_catalog_mw(n_h2o=16, n_o2=8),
            nmol=22, device="cpu")
s = synthetic_state(nlay=4, batch=2, device="cpu", dtype=torch.float32)
engine, lor = m.engine_split(s)
emis = torch.full((len(wn),), 0.95)
s.t.requires_grad_()
tb = m.tb(s, 288.0, emis, 1.0 - emis, irt=3, engine=engine, lor_layers=lor)
assert tb.shape == (2, 32) and bool(torch.isfinite(tb).all())
tb.sum().backward()
assert bool(torch.isfinite(s.t.grad).all()) and bool((s.t.grad != 0).any())
print(sorted(k for k in sys.modules
             if k.startswith("jax") or k.split(".")[0] == "monortm_tpu"))
"""


def _run(args, env=None, cwd=ROOT, timeout=240):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _env(**extra):
    env = dict(os.environ)
    env.update(extra)
    return env


def test_port_never_imports_jax():
    res = _run(["-c", TINY_FORWARD], env=_env(OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Here (no CUDA) the script must exit non-zero and print no result;
    so must a copy standing alone, without the package beside it."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        res = _run([str(script)], env=_env(CUDA_VISIBLE_DEVICES=""),
                   cwd=cwd)
        assert res.returncode != 0, res.stdout
        assert '"ok": true' not in res.stdout
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                assert json.loads(line).get("ok") is not True


def test_kernel_module_imports_without_toolchain():
    """No nvcc on PATH, no CUDA_HOME, no triton: the kernel module still
    imports, builds nothing, and CPU tensors take the plain version."""
    code = (
        "import sys, torch\n"
        "from monortm_tpu_torch.ops import linesum_kernel as lk\n"
        "from monortm_tpu_torch.ops import linesum, linesum_lorentz\n"
        "assert 'triton' not in sys.modules\n"
        "assert not lk.BUILD_DIR.exists() or not any(\n"
        "    p.stat().st_mtime > START for p in lk.BUILD_DIR.iterdir())\n"
        "assert linesum.VOIGT_KERNEL.launches == 0\n"
        "print('ok')\n")
    res = _run(["-c", f"START = {time.time()}\n" + code],
               env=_env(PATH=os.path.dirname(sys.executable),
                        CUDA_HOME="/nonexistent"))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# the CLI run as __main__ (IATM=0 rundir, then an IATM=1 one), then the
# modules the process loaded
CLI_MAIN = """
import runpy, sys
from pathlib import Path
from monortm_tpu_torch.testing import make_minimal_rundir
d = Path(sys.argv[1])
make_minimal_rundir(d, nprof=2)
(d / "i1").mkdir()
(d / "i1" / "MONORTM.IN").write_text(sys.argv[2])
for rd in (d, d / "i1"):
    sys.argv = ["monortm-tpu-torch", "--in", str(rd / "MONORTM.IN"),
                "--prof", str(d / "MONORTM_PROF.IN"), "--tape3",
                str(d / "TAPE3"), "--outdir", str(rd / "out"),
                "--device", "cpu", "--netcdf"]
    try:
        runpy.run_module("monortm_tpu_torch.cli", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
    assert (rd / "out" / "MONORTM.OUT").stat().st_size > 0
assert (d / "i1" / "out" / "TAPE7").exists()
print(sorted(k for k in sys.modules
             if k.startswith("jax") or k.split(".")[0] == "monortm_tpu"))
"""

PIPELINE_MODULES = (
    "pipeline.py", "cli.py", "envelope.py", "types.py", "host_types.py",
    "lines.py", "testing.py",
    "io/tape3.py", "io/tape5.py", "io/profin.py", "io/emis.py",
    "io/cldod.py", "io/tape7.py", "io/fscdxs.py", "io/output.py",
    "atmos/layering.py", "atmos/tape5_atm.py", "utils/trace.py",
    "utils/__init__.py", "models/rt.py", "models/od.py",
    "ops/continuum.py", "ops/xsec.py", "native/__init__.py",
    "parallel/__init__.py", "parallel/distributed.py",
    "parallel/sharding.py", "parallel/linesharded.py")


def test_cli_as_main_never_imports_jax(tmp_path):
    from tests.test_torch_io import iatm1_tape5
    res = _run(["-c", CLI_MAIN, str(tmp_path), iatm1_tape5()],
               env=_env(OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    assert "PROCESSING PROFILE NUMBER" in res.stdout
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


# the envelope entry point as `python -m` at a tiny size on the CPU, then
# the modules the process loaded
ENVELOPE_MAIN = """
import runpy, sys
sys.argv = ["envelope", "--device", "cpu", "--nlay", "3", "--lines", "30",
            "--nwn", "200", "--outdir", sys.argv[1]]
try:
    runpy.run_module("monortm_tpu_torch.envelope", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
print(sorted(k for k in sys.modules
             if k.startswith("jax") or k.split(".")[0] == "monortm_tpu"))
"""


def test_envelope_as_main_never_imports_jax(tmp_path):
    res = _run(["-c", ENVELOPE_MAIN, str(tmp_path)],
               env=_env(OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    assert "finite=True" in res.stdout
    assert (tmp_path / "MONORTM.OUT").stat().st_size > 0
    assert res.stdout.strip().splitlines()[-1] == "[]", res.stdout


# one rank of a 1x2 mesh: a value_and_grad through the all-Lorentz engine,
# then the modules the process loaded
MESH_RANK = """
import sys
import numpy as np
import torch
from monortm_tpu_torch.models.monortm import MonoRTM
from monortm_tpu_torch.parallel import distributed
from monortm_tpu_torch.parallel.sharding import (make_mesh,
                                                 shard_forward_and_grad)
from monortm_tpu_torch.testing import synthetic_catalog_mw, synthetic_state
distributed.init_distributed("gloo")
mesh = make_mesh(n_prof=1, n_wn=2)
wn = np.linspace(0.3, 55.0, 160)
m = MonoRTM(wn, float(wn[1] - wn[0]), synthetic_catalog_mw(n_h2o=16, n_o2=8),
            nmol=22, device="cpu", line_tile=128, mesh=mesh)
s = synthetic_state(nlay=3, batch=2, device="cpu", dtype=torch.float32)
emis = torch.full((160,), 0.95)
loss, g = shard_forward_and_grad(m, mesh, 3, "lorentz")(
    s, 288.0, emis, 1.0 - emis, torch.full((2, 160), 250.0))
assert bool(torch.isfinite(g.t).all()) and bool((g.t != 0).any())
torch.distributed.destroy_process_group()
print(sorted(k for k in sys.modules
             if k.startswith("jax") or k.split(".")[0] == "monortm_tpu"))
"""


def test_mesh_ranks_never_import_jax():
    from monortm_tpu_torch.parallel.distributed import spawn
    outs = spawn(["-c", MESH_RANK], 2, env=_env(OMP_NUM_THREADS="1"),
                 cwd=ROOT, timeout=240)
    for rc, text in outs:
        assert rc == 0, text
        assert text.strip().splitlines()[-1] == "[]", text


def test_pipeline_sources_never_import_jax():
    pkg = ROOT / "monortm_tpu_torch"
    bad = re.compile(r"^\s*(from|import)\s+(jax|monortm_tpu)(\.|\s|$)",
                     re.M)
    for name in PIPELINE_MODULES:
        text = (pkg / name).read_text()
        assert not bad.search(text), name
        assert "monortm_tpu.native" not in text.replace(
            "monortm_tpu_torch", ""), name


def test_cli_default_device_fails_without_a_gpu(tmp_path):
    """`python -m monortm_tpu_torch.cli` asks for the card by default:
    with none visible it raises and writes no MONORTM.OUT."""
    make = ("from monortm_tpu_torch.testing import make_minimal_rundir; "
            f"make_minimal_rundir({str(tmp_path)!r})")
    assert _run(["-c", make]).returncode == 0
    res = _run(["-m", "monortm_tpu_torch.cli", "--in",
                str(tmp_path / "MONORTM.IN"), "--prof",
                str(tmp_path / "MONORTM_PROF.IN"), "--tape3",
                str(tmp_path / "TAPE3"), "--outdir", str(tmp_path / "out")],
               env=_env(CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert "CUDA" in res.stderr
    assert not (tmp_path / "out" / "MONORTM.OUT").exists()


# a parent with torch and the CLI's module loaded: the layering of a
# stacked IATM=1 file through a 2-worker pool, then the profiles, the
# pool's count of workers without torch and whether the parent has torch
POOL_PARENT = """
import sys
import torch
import monortm_tpu_torch.cli
from monortm_tpu_torch.atmos.tape5_atm import profiles_from_tape5_iter
if __name__ == "__main__":
    n = []
    profs = list(profiles_from_tape5_iter(sys.argv[1], None, workers=2,
                                          report=n.append))
    print(len(profs), n, "torch" in sys.modules)
"""


@pytest.mark.parametrize("parent", ["-c", "script"])
def test_layering_workers_start_without_torch(parent, tmp_path):
    from tests.test_torch_io import stacked_iatm1_tape5
    tape5 = tmp_path / "MONORTM.IN"
    tape5.write_text(stacked_iatm1_tape5(8))
    if parent == "script":
        script = tmp_path / "parent.py"
        script.write_text(POOL_PARENT)
        args = [str(script)]
    else:
        args = ["-c", POOL_PARENT]
    path = os.pathsep.join(filter(None, [str(ROOT),
                                         os.environ.get("PYTHONPATH")]))
    res = _run([*args, str(tape5)],
               env=_env(OMP_NUM_THREADS="1", PYTHONPATH=path))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "8 [2] True", res.stdout
