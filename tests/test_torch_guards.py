"""Guards for the port's ground rules.

* The port (``src/repro_torch/``) and ``chip_smoke.py`` import neither jax
  nor anything of the reference package ``repro``.
* Entry points default to the CUDA card and raise without one; they never
  fall back to the CPU on their own.
* Importing the port builds nothing and starts nothing.
* The port's test files leave process-global state alone (``jax.config``,
  the torch default dtype, ``os.environ``), since the xdist workers run
  them in the same process as the reference's tests.
* The symbolic planner makes no host syncs; every δ fallback read is
  counted.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.api as JA
import repro.data.synthetic as JS
import repro_torch.api as TA
import repro_torch.core as TC
import repro_torch.data.synthetic as TS
from repro_torch.device import NoCUDADeviceError, resolve_device
from repro_torch.relalg import Table, forbid_transfers
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = _port_files()
    assert len(files) > 20 and os.path.exists(files[0])
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad


def test_port_tests_leave_process_state_alone():
    tests = [os.path.join(REPO, "tests", f)
             for f in os.listdir(os.path.join(REPO, "tests"))
             if f.startswith("test_torch_") and f.endswith(".py")]
    assert len(tests) >= 5
    for path in tests:
        src = open(path).read()
        name = os.path.basename(path)
        for banned in ("jax.config", "set_default_dtype",
                       "os.environ[", "os.environ.update", "putenv",
                       "@given"):
            assert banned not in src or name == "test_torch_guards.py", \
                (name, banned)
        assert "torch.set_num_threads(1)" in src, name
        assert "with isolated_plan_caches():" in src, name


def test_plan_cache_isolation_puts_the_reference_cache_back():
    # what a reference test that ran earlier in the worker left behind
    JA.PLAN_CACHE.put(("earlier",), "entry")
    JA.PLAN_CACHE.get(("earlier",))
    JA.PLAN_CACHE.get(("missing",))
    before = (list(JA.PLAN_CACHE._entries.items()), JA.PLAN_CACHE.hits,
              JA.PLAN_CACHE.misses)
    with isolated_plan_caches():
        assert len(JA.PLAN_CACHE) == 0 and JA.PLAN_CACHE.misses == 0
        JA.KGEngine(JS.make_group_b_dis(24, 0.6, seed=0)).create_kg()
        TA.KGEngine(TS.make_group_b_dis(24, 0.6, seed=0, device="cpu"),
                    device="cpu").create_kg()
        assert len(JA.PLAN_CACHE) == 1 and len(TA.PLAN_CACHE) == 1
    assert (list(JA.PLAN_CACHE._entries.items()), JA.PLAN_CACHE.hits,
            JA.PLAN_CACHE.misses) == before
    assert len(TA.PLAN_CACHE) == 0


def test_importing_the_port_builds_and_starts_nothing():
    code = ("import sys; import repro_torch.api, repro_torch.kernels."
            "selfcheck; from repro_torch.kernels import _lib; "
            "assert _lib._LIB is None; "
            "assert 'triton' not in sys.modules and 'jax' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    dis = TS.make_group_b_dis(16, 0.5, seed=0, device="cpu")
    with pytest.raises(NoCUDADeviceError):
        TA.KGEngine(dis)
    with pytest.raises(NoCUDADeviceError):
        TS.make_group_b_dis(16, 0.5, seed=0)
    with pytest.raises(NoCUDADeviceError):
        Table.from_codes(np.zeros((2, 2), np.int32), ["a", "b"])
    with pytest.raises(NoCUDADeviceError):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    assert TA.KGEngine(dis, device="cpu").device.type == "cpu"


def test_symbolic_planner_makes_no_host_syncs():
    dis = TS.make_group_a_dis(64, 0.5, seed=1, device="cpu")
    with forbid_transfers() as ledger:
        plan = TC.plan_mapsdi(dis)
    assert ledger.device_to_host == 0 and plan.maps


def test_forbid_transfers_raises_on_a_counted_read():
    t = Table.from_codes(np.zeros((3, 2), np.int32), ["a", "b"],
                         device="cpu")
    with pytest.raises(RuntimeError, match="device→host"):
        with forbid_transfers():
            t.to_codes()


def test_engine_counts_its_host_reads():
    from repro_torch.relalg import count_transfers
    dis = TS.make_group_b_dis(5000, 0.5, seed=2, device="cpu")
    eng = TA.KGEngine(dis, config=TA.EngineConfig(dedup="hash"),
                      device="cpu")
    eng.create_kg()
    with count_transfers() as ledger:
        eng.run()
    # the overflow flag, the source buckets of the cache key, and one
    # flag per hash δ (the ≥4096-row δs read the radix flag)
    assert 3 <= ledger.device_to_host <= 16


# ---------------------------------------------------------------------------
# the repo's invariant linter (tools/lint_invariants.py) over the port
# ---------------------------------------------------------------------------

#: the port's counterparts of the linter's FINGERPRINT_MODULES, and the
#: mesh, whose ``Mesh.key`` and ``Mesh.signature`` feed the store key
PORT_KEY_MODULES = ("plan/ir.py", "api/store.py", "api/cache.py",
                    "api/engine.py", "query/spec.py", "launch/mesh.py")


def _lint_tool():
    import importlib.util
    path = os.path.join(REPO, "tools", "lint_invariants.py")
    spec = importlib.util.spec_from_file_location("lint_invariants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_invariant_linter_passes_over_the_port_key_modules():
    lint = _lint_tool()
    expected = {os.path.basename(p) for p in lint.FINGERPRINT_MODULES}
    assert {os.path.basename(p) for p in PORT_KEY_MODULES} >= expected
    errors, allowed = [], []
    for rel in PORT_KEY_MODULES:
        path = os.path.join(PORT, rel)
        source = open(path).read()
        lines = source.splitlines()
        visitor = lint._StabilityVisitor(path, lines)
        visitor.visit(ast.parse(source, filename=path))
        errors += visitor.errors
        allowed += [(rel, i + 1) for i, line in enumerate(lines)
                    if lint.ALLOW_PRAGMA in line]
    assert errors == []
    # the only pragmas: Mesh.key and Mesh.signature keep the axes in the
    # mesh's own order, which is part of its identity
    assert [rel for rel, _ in allowed] == ["launch/mesh.py"] * 2
    mesh_lines = open(os.path.join(PORT, "launch", "mesh.py")).read() \
        .splitlines()
    for _, n in allowed:
        assert "tuple(self.shape.items())" in mesh_lines[n - 1]


def test_invariant_linter_flags_an_unsorted_key_iteration():
    lint = _lint_tool()
    source = ("def cache_key(d):\n"
              "    return tuple(d.items())\n"
              "def other_key(d):\n"
              "    return tuple(sorted(d.items()))\n")
    visitor = lint._StabilityVisitor(os.path.join(REPO, "x.py"),
                                     source.splitlines())
    visitor.visit(ast.parse(source))
    assert len(visitor.errors) == 1 and ":2:" in visitor.errors[0]


def test_every_kernel_package_keeps_the_triple():
    kroot = os.path.join(PORT, "kernels")
    names = sorted(n for n in os.listdir(kroot)
                   if os.path.isdir(os.path.join(kroot, n))
                   and not n.startswith(("_", "csrc")))
    assert names == ["flash_attention", "mamba2", "radix_partition",
                     "rowhash", "rwkv6"]
    for name in names:
        pkg = os.path.join(kroot, name)
        for required in ("ref.py", "kernel.py", "ops.py"):
            assert os.path.exists(os.path.join(pkg, required)), \
                (name, required)
        ops = open(os.path.join(pkg, "ops.py")).read()
        assert "resolve_use_kernel" in ops, name
        assert "from repro_torch.kernels import resolve_use_kernel" in ops, \
            name
