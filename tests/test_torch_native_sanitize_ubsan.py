"""The port's native tests under UndefinedBehaviorSanitizer: a child
``pytest`` over the ``native_san`` tests of the native, serve-kernel and
host-backend suites with ``MRI_NATIVE_SANITIZE=ubsan`` (the port's
loader builds and loads ``libmri_torch_scan_ubsan_<hash>.so``, built
with ``-fno-sanitize-recover``: the first undefined behaviour aborts).
The child must exit 0 with no sanitizer report.  ``native_san`` selects
the same tests as the ASan run."""

import os
import subprocess
import sys

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import native

from conftest import REPO_ROOT

SUITES = ["tests/test_torch_native.py", "tests/test_torch_native_serve.py",
          "tests/test_torch_parallel_host.py", "tests/test_torch_spill.py",
          "tests/test_torch_recovery.py"]
CHILD_TIMEOUT_S = 600  # the sanitized build is most of it
REPORTS = ("ERROR: AddressSanitizer", "runtime error:", "SUMMARY: AddressSanitizer",
           "SUMMARY: UndefinedBehaviorSanitizer")


def run_sanitized(variant: str, **env_extra) -> str:
    """Run the ``native_san`` selection in a child under ``variant``;
    assert it passed with no sanitizer report and that the variant's
    library was built.  Returns the child's output."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env.update(MRI_NATIVE_SANITIZE=variant, **env_extra)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", *SUITES, "-q", "-m", "native_san and not slow",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-6000:]
    assert not [r for r in REPORTS if r in out], out[-6000:]
    assert " passed" in proc.stdout and " failed" not in proc.stdout, proc.stdout[-2000:]
    assert any(native._SO_NAME_RE[variant].match(p.name)
               for d in native._build_dirs() if d.is_dir() for p in d.iterdir())
    return out


def test_native_tests_pass_under_ubsan():
    run_sanitized("ubsan")
