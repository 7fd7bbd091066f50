"""The port's native tests under AddressSanitizer: a child ``pytest`` over
the ``native_san`` tests of the native, serve-kernel and host-backend
suites, with ``MRI_NATIVE_SANITIZE=asan`` (the port's loader builds and
loads ``libmri_torch_scan_asan_<hash>.so``), ``libasan`` preloaded into
the interpreter and leak checking off (a long-lived interpreter never
frees everything).  The child must exit 0 with no sanitizer report.
The ``native_san`` marker leaves out every test that runs JAX code:
jaxlib's bundled MLIR aborts under ASan's ``__cxa_throw`` interceptor,
and the JAX package's loader would build its own sanitized library.
One child, so one sanitized build (most of the file's time)."""

import subprocess

from test_torch_native_sanitize_ubsan import run_sanitized


def test_native_tests_pass_under_asan():
    libasan = subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                             text=True, check=True).stdout.strip()
    run_sanitized("asan", LD_PRELOAD=libasan, ASAN_OPTIONS="detect_leaks=0")
