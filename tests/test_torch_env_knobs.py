"""The port's environment switches against the JAX reference's.

Both packages' sources are read as text (neither is imported) for the
reads of `HALO2_TPU_[A-Z0-9_]+` variables: `environ.get("NAME"...)`,
`environ["NAME"]`, `getenv("NAME"...)` and `"NAME" in environ`; a name
in a comment or a docstring is no read.  Every variable the reference reads must be
read by the port too, or stand in NOT_TO_PORT_ENV with its reason; every
listed variable must still be one the reference reads and one the port
does not.  The port's own HALO2_TPU_BENCH_* variables belong to its bench
and are left out.  The behaviour behind the five ported switches is held
against the reference in test_torch_e2e_lookup.py."""

import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG = os.path.join(ROOT, "halo2_tpu")
PORT_PKG = os.path.join(ROOT, "halo2_tpu_torch")
_NAME = r"""["'](HALO2_TPU_[A-Z0-9_]+)["']"""
ENV_READ = re.compile(rf"(?:environ\.get|getenv)\(\s*{_NAME}"
                      rf"|environ\[\s*{_NAME}\s*\]"
                      rf"|{_NAME}\s+in\s+(?:os\.)?environ\b")
PORT_OWN = "HALO2_TPU_BENCH_"

# Reference variables with no counterpart in the port, each with its
# reason.
NOT_TO_PORT_ENV = {
    "HALO2_TPU_EAGER_H": "runs the reference's h pass eagerly instead of "
                         "as one traced XLA computation; the port is "
                         "eager throughout",
    "HALO2_TPU_NO_AOT": "turns off the reference's JAX trace-export cache "
                        "(aot.py, not ported); the port's build cache is "
                        "_build.py's, for nvcc",
    "HALO2_TPU_NO_PALLAS": "routes the reference's field and curve ops to "
                           "plain jnp; the port's plain versions take any "
                           "CPU tensor, and a CUDA tensor always takes its "
                           "kernel",
    "HALO2_TPU_FUSED_NTT_MIN_LOGN": "the size at which the reference "
                                    "switches between its two NTT paths; "
                                    "every port transform is the "
                                    "four-step one on kernel C",
    "HALO2_TPU_STREAM_LANES": "the TPU lane width of the stream MSM; the "
                              "port's kernels D and 8 size their own "
                              "pieces (stream_msm.pieces_for)",
    "HALO2_TPU_SCAN_LANES": "the TPU lane width of the segmented scan; "
                            "kernel 9 takes one wave of lanes "
                            "(bucket_scan.block_for)",
    "HALO2_TPU_NTT_CHUNK_MB": "the TPU's per-dispatch NTT footprint; the "
                              "port's is the constant NTT_CHUNK_BYTES "
                              "(poly/domain.py), sized for an 80 GB card",
    "HALO2_TPU_EVAL_STACK_ROWS": "the TPU's rows per stacked evaluation; "
                                 "the port's is the constant "
                                 "EVAL_STACK_ROWS (poly/arith.py), sized "
                                 "for an 80 GB card",
    "HALO2_TPU_STREAM_C": "the stream MSM's window width; kernels D and 8 "
                          "are built for the constant STREAM_C, so the "
                          "port has no width option (a deliberate "
                          "deviation)",
    "HALO2_TPU_NO_NATIVE": "turns off the reference's native host library; "
                           "the port's copy builds with g++ and falls back "
                           "to pure Python only when the build fails",
    "HALO2_TPU_NATIVE_CACHE": "the reference's native build directory; the "
                              "port builds into halo2_tpu_torch/_build/"
                              "native, one file per process",
}


def env_reads(text: str) -> list:
    """[(variable, line), ...] of the reads in one file's source."""
    return [(next(g for g in m.groups() if g),
             text.count("\n", 0, m.start()) + 1)
            for m in ENV_READ.finditer(text)]


def env_names(pkg: str) -> dict:
    """{variable: [file:line, ...]} of the reads over the package's Python
    sources."""
    out: dict = {}
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                for name, i in env_reads(fh.read()):
                    out.setdefault(name, []).append(
                        f"{os.path.relpath(path, ROOT)}:{i}")
    return out


@pytest.mark.parametrize("src, want", [
    ('on = os.environ.get("HALO2_TPU_X") == "1"', [("HALO2_TPU_X", 1)]),
    ('n = int(os.environ.get(\n    "HALO2_TPU_X", "256"))',
     [("HALO2_TPU_X", 1)]),
    ("d = os.environ['HALO2_TPU_X']", [("HALO2_TPU_X", 1)]),
    ('d = os.getenv("HALO2_TPU_X")', [("HALO2_TPU_X", 1)]),
    ('\nif "HALO2_TPU_X" in os.environ:', [("HALO2_TPU_X", 2)]),
    ('"""HALO2_TPU_X=1 turns the checks on."""', []),
    ('# read HALO2_TPU_X here', []),
    ('os.environ.get(name)  # HALO2_TPU_X', []),
])
def test_only_reads_count(src, want):
    assert env_reads(src) == want


REF_ENV = env_names(REF_PKG)
PORT_ENV = {k: v for k, v in env_names(PORT_PKG).items()
            if not k.startswith(PORT_OWN)}


@pytest.mark.parametrize("name", sorted(REF_ENV))
def test_reference_variable_is_read_by_the_port_or_listed(name):
    if name in NOT_TO_PORT_ENV:
        assert NOT_TO_PORT_ENV[name]
        return
    assert name in PORT_ENV, (
        f"{name} (read at {REF_ENV[name]}) is neither read by the port "
        f"nor listed in NOT_TO_PORT_ENV with a reason")


@pytest.mark.parametrize("name", sorted(NOT_TO_PORT_ENV))
def test_listed_variable_is_read_by_the_reference_only(name):
    assert name in REF_ENV, f"{name} is listed, but the reference no " \
                            f"longer reads it"
    assert name not in PORT_ENV, f"{name} is listed, but the port reads " \
                                 f"it at {PORT_ENV.get(name)}"


def test_port_reads_no_variable_of_its_own():
    """Outside its bench, the port reads only variables the reference
    reads, so each has the reference's meaning."""
    assert sorted(set(PORT_ENV) - set(REF_ENV)) == []
