"""The port's quantity parser (csrc/quantity.cpp, built at first use by
ops/kernels.py `load_quantity`) against the Fraction path: the cases of
the JAX package's tests/test_native.py on the port's parser (the samples
at every scale and rounding, the fuzz, invalid inputs, the batch and
`encode_requests`, the speed sanity), then the port's parser against the
JAX package's Fraction path and factory on the same seeded inputs, and
against the JAX package's own compiled parser (native/quantity.cpp built
into a temporary directory). Also: the default batch encoding runs the
compiled parser and `from_map` is the Fraction path, a batch outside
the parser's grammar takes the Fraction path, a failed build raises with
the compiler's message, and processes that build at once each load a
whole library."""

import importlib.machinery
import importlib.util
import math
import os
import shutil
import subprocess
import sys
import textwrap
from fractions import Fraction

import numpy as np
import pytest
import torch_cpu  # noqa: F401

from armada_tpu.core import resources as ref_resources
from armada_tpu_torch.core.resources import ResourceListFactory, parse_quantity
from armada_tpu_torch.ops import kernels
from torch_conformance import fuzz_quantities, native_samples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALES = (-3, 0, 3, 8)
SAMPLES = native_samples()


@pytest.fixture(scope="module")
def native():
    return kernels.load_quantity()


def py_scale(value, scale: int, ceil: bool, parse=parse_quantity) -> int:
    scaled = parse(value) / (Fraction(10) ** scale)
    value = int(math.ceil(scaled) if ceil else math.floor(scaled))
    return min(max(value, -(2**63)), 2**63 - 1)  # saturating, like the parser


def seeded_requests(seed=18, n=400):
    """Request dicts over four resources with the fuzz's quantities, some
    keys absent, an unknown resource now and then."""
    rng = np.random.default_rng(seed)
    names = ("cpu", "memory", "nvidia.com/gpu", "ephemeral-storage", "unknown/thing")
    reqs = []
    for _ in range(n):
        req = {}
        for name in names:
            if rng.random() < 0.7:
                q, _, _ = fuzz_quantities(int(rng.integers(0, 2**31)), 1)[0]
                req[name] = q if rng.random() < 0.8 else int(rng.integers(0, 10**6))
        reqs.append(req)
    return reqs


def factories(module):
    return module.ResourceListFactory.create(
        [("memory", "1"), ("cpu", "1m"), ("ephemeral-storage", "1"), ("nvidia.com/gpu", "1")]
    )


# tests/test_native.py's cases on the port's parser.


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("ceil", [True, False])
def test_samples_match_fraction_path(native, scale, ceil):
    for value in SAMPLES:
        expected = py_scale(value, scale, ceil)
        got = native.parse_quantity(value, scale, ceil)
        assert got == expected, (value, scale, ceil, got, expected)
        assert expected == py_scale(value, scale, ceil, ref_resources.parse_quantity)


def test_fuzz_random_quantities(native):
    for s, scale, ceil in fuzz_quantities():
        assert native.parse_quantity(s, scale, ceil) == py_scale(s, scale, ceil), s


def test_invalid_inputs_raise(native):
    for bad in ["", "abc", "1.2.3", "12X", "e3", "--1"]:
        with pytest.raises(ValueError):
            native.parse_quantity(bad, 0, True)


def test_batch_and_encode_requests(native):
    f = ResourceListFactory.create([("memory", "1"), ("cpu", "1m"), ("nvidia.com/gpu", "1")])
    reqs = [
        {"cpu": "2", "memory": "4Gi"},
        {"cpu": "500m", "memory": "1.5Gi", "nvidia.com/gpu": "1"},
        {},
        {"unknown/thing": "7", "cpu": "1"},
    ]
    got = f.encode_requests_batch(reqs, ceil=True)
    expected = np.stack([f.from_map(r, ceil=True) for r in reqs])
    assert (got == expected).all()
    raw = native.encode_requests(reqs, list(f.names), list(f.scales), True)
    assert (np.frombuffer(raw, dtype=np.int64).reshape(len(reqs), -1) == expected).all()
    values = [v for v, _, _ in fuzz_quantities(1, 200)]
    raw = native.parse_quantities(values, 0, False)
    assert np.frombuffer(raw, dtype=np.int64).tolist() == [py_scale(v, 0, False) for v in values]


def test_batch_speed_sanity(native):
    import time

    f = ResourceListFactory.create([("memory", "1"), ("cpu", "1m")])
    reqs = [{"cpu": "1500m", "memory": "16Gi"}] * 50_000
    t0 = time.time()
    f.encode_requests_batch(reqs, ceil=True)
    native_t = time.time() - t0
    # 50k jobs in well under a second (the reference's bound)
    assert native_t < 1.0, f"native batch too slow: {native_t:.2f}s"


# The port's parser against the JAX package.


@pytest.mark.parametrize("ceil", [True, False])
def test_encode_matches_reference_factory(native, ceil):
    """Seeded request batches: the port's default encoding (the compiled
    parser), its Fraction path and the JAX package's factory give the same
    rows; so do the per-value parses at every scale."""
    reqs = seeded_requests()
    port = factories(sys.modules["armada_tpu_torch.core.resources"])
    ref = factories(ref_resources)
    got = port.encode_requests_batch(reqs, ceil=ceil)
    assert got.dtype == np.int64 and got.shape == (len(reqs), 4)
    assert np.array_equal(got, np.stack([port.from_map(r, ceil=ceil) for r in reqs]))
    assert np.array_equal(got, ref.encode_requests_batch(reqs, ceil=ceil))
    for s, _, _ in fuzz_quantities(2, 300):
        for scale in SCALES:
            assert native.parse_quantity(s, scale, ceil) == \
                py_scale(s, scale, ceil, ref_resources.parse_quantity), (s, scale)


def _build_reference_parser(tmp_path):
    """native/quantity.cpp compiled in a copy under `tmp_path` and loaded
    from there (never importable as `_armada_native`), or None where it
    does not build."""
    import sysconfig

    src = tmp_path / "quantity.cpp"
    shutil.copy(os.path.join(ROOT, "native", "quantity.cpp"), src)
    out = tmp_path / f"_armada_native{sysconfig.get_config_var('EXT_SUFFIX')}"
    try:
        subprocess.run([kernels._cxx(), *kernels.CXX_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True, timeout=300)
    except (RuntimeError, subprocess.CalledProcessError):
        return None
    loader = importlib.machinery.ExtensionFileLoader("_armada_native", str(out))
    spec = importlib.util.spec_from_file_location("_armada_native", str(out), loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def test_matches_reference_compiled_parser(native, tmp_path):
    """The JAX package's C++ parser, built from native/quantity.cpp in a
    temporary copy: every sample, fuzz value and seeded batch parses to
    the same integers, and the same inputs raise."""
    ref = _build_reference_parser(tmp_path)
    if ref is None:
        pytest.skip("native/quantity.cpp does not build here (no C++ toolchain)")
    for value in SAMPLES:
        for scale in SCALES:
            for ceil in (True, False):
                assert native.parse_quantity(value, scale, ceil) == \
                    ref.parse_quantity(value, scale, ceil), (value, scale, ceil)
    for s, scale, ceil in fuzz_quantities(3):
        assert native.parse_quantity(s, scale, ceil) == ref.parse_quantity(s, scale, ceil), s
    f = factories(sys.modules["armada_tpu_torch.core.resources"])
    reqs = seeded_requests(19)
    for ceil in (True, False):
        args = (reqs, list(f.names), list(f.scales), ceil)
        assert native.encode_requests(*args) == ref.encode_requests(*args)
    for bad in ["", "abc", "1.2.3", "12X", "e3", "--1"]:
        for parser in (native, ref):
            with pytest.raises(ValueError):
                parser.parse_quantity(bad, 0, True)


# The encode paths, the grammar fallback and the build.


def test_default_encoding_runs_the_compiled_parser(native, monkeypatch):
    """The default batch encoding parses through the compiled parser and
    never through `from_map`, the Fraction path, which gives the same
    rows one request at a time and never loads the parser."""
    f = factories(sys.modules["armada_tpu_torch.core.resources"])
    reqs = seeded_requests(20, 50)
    calls = {"from_map": 0, "load": 0}
    from_map, load = ResourceListFactory.from_map, kernels.load_quantity

    def counted_from_map(self, *a, **k):
        calls["from_map"] += 1
        return from_map(self, *a, **k)

    def counted_load():
        calls["load"] += 1
        return load()

    monkeypatch.setattr(ResourceListFactory, "from_map", counted_from_map)
    monkeypatch.setattr(kernels, "load_quantity", counted_load)
    got = f.encode_requests_batch(reqs, ceil=True)
    assert calls == {"from_map": 0, "load": 1}
    want = np.stack([f.from_map(r, ceil=True) for r in reqs])
    assert calls == {"from_map": len(reqs), "load": 1}
    assert np.array_equal(got, want)


def test_wider_grammar_takes_the_fraction_path(native):
    """A batch the compiled parser refuses (a Fraction, an exponent on a
    binary suffix) is encoded by the Fraction path, as in the JAX
    package (`_encode_unique`'s fallback)."""
    f = factories(sys.modules["armada_tpu_torch.core.resources"])
    ref = factories(ref_resources)
    reqs = [{"cpu": Fraction(3, 4), "memory": "1e3Ki"}, {"cpu": "2"}]
    with pytest.raises((ValueError, TypeError)):
        native.encode_requests(reqs, list(f.names), list(f.scales), True)
    got = f.encode_requests_batch(reqs, ceil=True)
    assert np.array_equal(got, np.stack([f.from_map(r, ceil=True) for r in reqs]))
    assert np.array_equal(got, ref.encode_requests_batch(reqs, ceil=True))


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    """A compiler that fails: load_quantity and the default encoding raise
    with its output; nothing falls back, nothing is left in the build
    directory."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'quantity.cpp:1: error: no such compiler' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_libs", {})
    with pytest.raises(RuntimeError, match="no such compiler"):
        kernels.load_quantity()
    f = factories(sys.modules["armada_tpu_torch.core.resources"])
    with pytest.raises(RuntimeError, match="no such compiler"):
        f.encode_requests_batch([{"cpu": "1"}], ceil=True)
    assert list((tmp_path / "build").iterdir()) == []


_BUILDER = textwrap.dedent(
    """
    import sys, pathlib
    sys.path.insert(0, ROOT)
    from armada_tpu_torch.ops import kernels
    kernels.BUILD_DIR = pathlib.Path(BUILD)
    q = kernels.load_quantity()
    assert q.parse_quantity("1.5Gi", 0, True) == 3 * 2**29
    print("LOADED", kernels._lib_path("quantity").name)
    """
)


def test_processes_building_at_once_each_load_a_whole_library(tmp_path):
    """Four processes build the parser into one empty directory at once:
    each renames its own whole file into place, so every one loads a
    working parser and one library is left, no temporary file."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = f"ROOT = {ROOT!r}\nBUILD = {str(tmp_path / 'build')!r}\n" + _BUILDER
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "LOADED" in out
    names = {out.split()[-1] for out, _ in outs}
    assert len(names) == 1
    assert sorted(os.listdir(tmp_path / "build")) == sorted(names)
