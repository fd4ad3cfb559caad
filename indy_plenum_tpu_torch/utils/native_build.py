"""Build-on-first-use loader for the repo's C extensions.

Copy of ``indy_plenum_tpu/utils/native_build.py`` (``build_native_ext``):
``gcc -O3 -shared -fPIC`` against the CPython headers, ABI-tagged
artifact names, mtime-based rebuild and an atomic tmp+rename publish, so
a concurrent importer (a test worker, a second process on the card
machine) never loads half an ELF. The port builds into its own
directories (``crypto/bls/_native_build/`` for BN254), apart from the
reference's.

A failed build raises ``RuntimeError`` with the compiler's command and
its stderr; a missing ``gcc`` raises ``FileNotFoundError``. Nothing falls
back to a pure-Python path.
"""
from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sysconfig

logger = logging.getLogger(__name__)


def build_native_ext(src_path: str, build_dir: str, name: str,
                     opt: str = "-O3"):
    """Compile ``src_path`` into ``build_dir`` (if stale) and import it."""
    src = os.path.abspath(src_path)
    os.makedirs(build_dir, exist_ok=True)
    # ABI-tagged artifact name: a .so built by one CPython must never be
    # loaded into another
    ext = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    so_path = os.path.join(build_dir, f"{name}{ext}")
    if (not os.path.exists(so_path)
            or os.path.getmtime(so_path) < os.path.getmtime(src)):
        include = sysconfig.get_paths()["include"]
        # build to a temp path + atomic rename: a concurrent importer must
        # never load a half-written ELF
        tmp_path = f"{so_path}.tmp.{os.getpid()}"
        cmd = ["gcc", opt, "-shared", "-fPIC", f"-I{include}",
               src, "-o", tmp_path]
        logger.info("building native extension: %s", " ".join(cmd))
        try:
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed ({' '.join(cmd)}, exit "
                    f"{done.returncode}):\n{done.stderr}")
            os.replace(tmp_path, so_path)
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
    spec = importlib.util.spec_from_file_location(name, so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
