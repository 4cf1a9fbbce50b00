"""Guards of the PyTorch port: it imports nothing of JAX or of the JAX
package, builds nothing when imported, never carries on on the CPU
unless asked, and refuses what its kernels do not take."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.swin_t import reduced
from repro_torch.core import runtime
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention_p
from repro_torch.kernels.layernorm import layernorm_p
from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p
from repro_torch.kernels.wkv import wkv_p
from repro_torch.launch import serve
from repro_torch.models import lm, vision
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.placement import TensorParallel

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120, cwd=ROOT)


def test_import_pulls_in_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.models.vision, "
        "repro_torch.kernels.ops, repro_torch.convert, "
        "repro_torch.models.lm, repro_torch.models.rwkv6, "
        "repro_torch.kernels.wkv, repro_torch.models.attention, "
        "repro_torch.models.blocks, repro_torch.models.mlp, "
        "repro_torch.models.rope, repro_torch.configs.deepseek_7b, "
        "repro_torch.configs.granite_20b, "
        "repro_torch.configs.internlm2_20b, repro_torch.launch.profile, "
        "repro_torch.serve.paging, repro_torch.serve.sampling, "
        "repro_torch.serve.engine, repro_torch.serve.faults, "
        "repro_torch.serve.spec, repro_torch.serve.prefix_cache, "
        "repro_torch.core.block_traffic, repro_torch.launch.serve, "
        "repro_torch.models.mamba2, repro_torch.models.moe, "
        "repro_torch.configs.zamba2, repro_torch.configs.qwen2_moe, "
        "repro_torch.configs.phi35_moe, repro_torch.serve.placement, "
        "repro_torch.core.partitioning, repro_torch.analysis, "
        "repro_torch.analysis.audit, repro_torch.analysis.smem, "
        "repro_torch.analysis.sync, repro_torch.analysis.donation, "
        "repro_torch.analysis.compile_bound, repro_torch.analysis.rules, "
        "repro_torch.analysis.dispatch, repro_torch.core.rowwise, "
        "repro_torch.core.asic_model, repro_torch.launch.roofline, "
        "repro_torch.launch.specs, repro_torch.configs.shapes, "
        "repro_torch.launch.op_cost, repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = _run(code, env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py",
     *(ROOT / "examples").glob("torch_*.py")]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_source_scan_covers_the_analysis_package():
    scanned = {p.relative_to(PORT).parts[0] for p in PORT.rglob("*.py")}
    assert "analysis" in scanned
    assert {p.name for p in (PORT / "analysis").glob("*.py")} >= {
        "audit.py", "sync.py", "donation.py", "compile_bound.py",
        "smem.py", "rules.py", "dispatch.py", "report.py"}
    assert {p.name for p in (PORT / "launch").glob("*.py")} >= {
        "dryrun.py", "op_cost.py"}
    assert {p.name for p in (ROOT / "examples").glob("torch_*.py")} == {
        "torch_quickstart.py", "torch_vit_rowwise.py", "torch_serve_lm.py",
        "torch_train_lm.py"}


def test_audit_and_roofline_refuse_to_fall_back_to_cpu():
    """The audit CLI and the roofline run on the card unless given
    ``--device cpu``: with no card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.analysis import audit
    from repro_torch.launch import roofline
    with pytest.raises(RuntimeError, match="CUDA"):
        audit.main(["--passes", "rules"])
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.main(["--smoke"])


def test_build_module_imports_without_nvcc():
    env = {**os.environ, "PATH": "/nonexistent",
           "PYTHONPATH": str(ROOT / "src")}
    out = _run("import repro_torch.kernels._build as b; "
               "print(b.LIBRARY.relative_to(b.BUILD_DIR.parents[1]))", env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "build/repro_torch/libkernels.so"


def test_build_without_nvcc_raises(monkeypatch):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_entry_points_refuse_to_fall_back_to_cpu():
    """With no card and no device='cpu', the entry points raise rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        vision.SwinTransformer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        vision.init_swin(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.resolve_device()
    assert vision.SwinTransformer(cfg, device="cpu")(
        torch.zeros(1, 56, 56, 3)).shape == (1, 10)
    lcfg = get_reduced("rwkv6-3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.LanguageModel(lcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_lm(lcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache(lcfg, 1)
    model = lm.LanguageModel(lcfg, device="cpu")
    assert model.greedy(torch.zeros(1, 3, dtype=torch.long), 2).shape == (
        1, 2)
    dense = get_reduced("deepseek-7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.LanguageModel(dense)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache(dense, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_paged_cache(dense, 1, 8)
    model = lm.LanguageModel(dense, device="cpu")
    assert model.greedy(torch.zeros(1, 3, dtype=torch.long), 2).shape == (
        1, 2)
    params = lm.init_lm(dense, torch.Generator().manual_seed(0),
                        device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params, dense)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--requests", "1"])
    eng = Engine(params, dense, n_slots=1, max_len=16, device="cpu")
    eng.submit(Request(rid=0, prompt=torch.zeros(3, dtype=torch.long),
                       max_new=2))
    assert [c.status for c in eng.run()] == ["ok"]


def test_tensor_parallel_never_falls_back(capsys):
    """A tensor-parallel engine with no process group raises rather than
    serve on one device; the CLI's ranks take the card unless told
    otherwise, and a backend that cannot run fails the run rather than
    give way to another."""
    dense = get_reduced("deepseek-7b")
    params = lm.init_lm(dense, torch.Generator().manual_seed(0),
                        device="cpu")
    with pytest.raises(ValueError, match="needs a process group of 2"):
        Engine(params, dense, n_slots=1, max_len=16, device="cpu",
               placement=TensorParallel(2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--smoke", "--requests", "1", "--mesh-shape",
                        "model=2"])
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="rank 0 exited"):
            serve.main(["--smoke", "--requests", "1", "--mesh-shape",
                        "model=2", "--device", "cpu", "--dist-backend",
                        "nccl", "--dist-timeout", "30"])


def test_impl_switch_is_auto_or_ref():
    assert runtime.resolve_impl() == "auto"
    with runtime.use_impl("ref"):
        assert runtime.resolve_impl() == "ref"
    assert runtime.resolve_impl() == "auto"
    for bad in ("pallas", "interpret", "triton", "cuda"):
        with pytest.raises(ValueError):
            runtime.set_impl(bad)


def test_wrappers_refuse_what_no_kernel_takes():
    x, w = torch.randn(4, 8), torch.randn(8, 6)
    # scales select the int8 W8A8 mode: float operands are refused
    with pytest.raises(TypeError, match="int8"):
        rowwise_matmul_p(x, w, x_scale=torch.ones(4, 1),
                         w_scale=torch.ones(1, 6))
    xq, wq = x.to(torch.int8), w.to(torch.int8)
    with pytest.raises(TypeError, match="x_scale"):
        rowwise_matmul_p(xq, wq, x_scale=torch.ones(4, 1, dtype=torch.int32),
                         w_scale=torch.ones(1, 6))
    with pytest.raises(TypeError, match="x_scale"):
        rowwise_matmul_p(xq, wq, w_scale=torch.ones(1, 6))
    with pytest.raises(ValueError, match="activation"):
        rowwise_matmul_p(x, w, activation="tanh")
    with pytest.raises(ValueError, match="kind"):
        layernorm_p(x, torch.ones(8), kind="group")
    # a device with no kernel: the wrappers' one check refuses it (a CPU
    # tensor never reaches it: the wrappers run its plain version first)
    for t in (x, torch.ones(2, dtype=torch.int64)):
        with pytest.raises(ValueError, match="no kernel"):
            _build.check_cuda("wrapper", t)
    # meta tensors (the dry run's, shapes alone) pass the checks and get
    # an empty output of the kernel's shape: no launch, no value
    launches = (rowwise_matmul_p.launches, flash_attention_p.launches,
                layernorm_p.launches, wkv_p.launches)
    q = torch.randn(1, 2, 4, 16, device="meta")
    r = torch.randn(1, 5, 2, 16, device="meta")
    outs = [rowwise_matmul_p(x.to("meta"), w.to("meta")),
            flash_attention_p(q, q, q),
            layernorm_p(x.to("meta"), torch.ones(8, device="meta")),
            *wkv_p(r, r, r, r, torch.ones(2, 16, device="meta"))]
    assert [tuple(o.shape) for o in outs] == [(4, 6), (1, 2, 4, 16), (4, 8),
                                              (1, 5, 2, 16), (1, 2, 16, 16)]
    assert all(o.is_meta for o in outs)
    assert (rowwise_matmul_p.launches, flash_attention_p.launches,
            layernorm_p.launches, wkv_p.launches) == launches


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.ones(*shape, dtype=dtype, device="meta",
                      requires_grad=grad)


@pytest.mark.parametrize("case", [
    ("kind", ValueError, lambda: layernorm_p(_meta(4, 8), _meta(8),
                                             kind="group")),
    ("x not 2-D", ValueError, lambda: layernorm_p(_meta(2, 4, 8),
                                                  _meta(8))),
    ("column stride", ValueError, lambda: layernorm_p(_meta(8, 4).t(),
                                                      _meta(8))),
    ("gamma shape", ValueError, lambda: layernorm_p(_meta(4, 8),
                                                    _meta(9))),
    ("beta shape", ValueError, lambda: layernorm_p(_meta(4, 8), _meta(8),
                                                   _meta(8, 1))),
    ("dtype", TypeError, lambda: layernorm_p(
        _meta(4, 8, dtype=torch.float16), _meta(8))),
    ("x grad", NotImplementedError, lambda: layernorm_p(
        _meta(4, 8, grad=True), _meta(8))),
    ("gamma grad", NotImplementedError, lambda: layernorm_p(
        _meta(4, 8), _meta(8, grad=True))),
    ("beta grad", NotImplementedError, lambda: layernorm_p(
        _meta(4, 8), _meta(8), _meta(8, grad=True))),
    ("device", ValueError, lambda: layernorm_p(_meta(4, 8), torch.ones(8))),
], ids=lambda c: c[0])
def test_layernorm_wrapper_refuses(case):
    """What the layernorm wrapper raised on before its host cost was cut,
    it raises on still, before any launch (meta tensors reach every check
    a launch makes, and past them get an empty output); under no_grad a
    gradient is no bar."""
    _name, error, call = case
    before = layernorm_p.launches
    with pytest.raises(error):
        call()
    if error is NotImplementedError:
        with torch.no_grad():
            out = call()
        assert out.is_meta and tuple(out.shape) == (4, 8)
    assert layernorm_p.launches == before


def test_cpu_path_builds_nothing():
    def counts():
        return (rowwise_matmul_p.launches, flash_attention_p.launches,
                layernorm_p.launches, wkv_p.launches)

    before = counts()
    rowwise_matmul_p(torch.randn(4, 8), torch.randn(8, 6))
    q = torch.randn(1, 2, 4, 16)
    flash_attention_p(q, q, q)
    layernorm_p(torch.randn(4, 8), torch.ones(8))
    r = -torch.rand(1, 5, 2, 16)
    wkv_p(r, r, r, r, torch.ones(2, 16))
    assert counts() == before
    assert _build.library.cache_info().currsize == 0


def test_int8_takes_the_plain_version_only_on_the_cpu(monkeypatch):
    """A CPU int8 call runs the plain version and builds nothing; an int8
    call on any other device goes to the kernel path (here a meta call:
    checked, answered with an empty output, no launch), never to the
    plain version."""
    from repro_torch.kernels import ref
    xq = torch.randint(-127, 128, (4, 8), dtype=torch.int8)
    wq = torch.randint(-127, 128, (8, 6), dtype=torch.int8)
    xs, ws = torch.rand(4, 1), torch.rand(1, 6)
    before = rowwise_matmul_p.launches
    out = rowwise_matmul_p(xq, wq, x_scale=xs, w_scale=ws)
    assert out.dtype == torch.float32 and out.shape == (4, 6)
    assert rowwise_matmul_p.launches == before
    assert _build.library.cache_info().currsize == 0

    def plain(*args, **kw):
        raise AssertionError("the plain version ran for a non-CPU tensor")
    monkeypatch.setattr(ref, "pipeline_ref", plain)
    out = rowwise_matmul_p(xq.to("meta"), wq.to("meta"),
                           x_scale=xs.to("meta"), w_scale=ws.to("meta"))
    assert out.is_meta and out.dtype == torch.float32 and out.shape == (4, 6)
    assert rowwise_matmul_p.launches == before
    assert _build.library.cache_info().currsize == 0


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: exit non-zero and print no result line, both in the repo
    and in a directory that holds chip_smoke.py alone."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    for where in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_mesh_modules_import_no_jax():
    """The training mesh's modules pull in nothing of JAX or of the JAX
    package, and building no mesh touches no process group."""
    code = ("import sys\n"
            "import repro_torch.launch.mesh, repro_torch.optim.compression, "
            "repro_torch.train.step, repro_torch.launch.train, "
            "repro_torch.checkpoint.checkpointer\n"
            "import torch.distributed as dist\n"
            "print(dist.is_initialized(), sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = _run(code, env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False []"


def test_mesh_refuses_what_it_cannot_form(tmp_path):
    """A mesh needs a process group of its size: without one, or in a
    world of another size, it raises (no quiet single-device run)."""
    import torch.distributed as dist

    from repro_torch.core import partitioning
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import step as tsl
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_host_mesh()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 8 ranks"):
            mesh_lib.make_host_mesh()
        mesh = mesh_lib.make_host_mesh((1, 1, 1))
        with pytest.raises(ValueError, match="'pod' axis"):
            tsl.state_shardings(get_reduced("deepseek-7b"),
                                tsl.TrainConfig(compress_pods=True),
                                partitioning.Mesh((1,), ("data",)))
        assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
    finally:
        dist.destroy_process_group()
