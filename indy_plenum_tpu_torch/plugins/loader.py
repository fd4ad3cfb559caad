"""Import-and-register plugin loader (reference: plenum's PLUGIN_ROOT).

Copy of ``indy_plenum_tpu/plugins/loader.py``."""
from __future__ import annotations

import importlib
import logging
from typing import Iterable

logger = logging.getLogger(__name__)

ENTRY_POINT = "plugin_entry"


class PluginLoadError(Exception):
    pass


def load_plugins(node, modules: Iterable[str]) -> int:
    """Import each module and call its ``plugin_entry(node)``; returns the
    number loaded.

    FAIL-FAST: a configured plugin that cannot load raises. For a BFT
    validator, silently running without a handler its peers have is worse
    than being down — the node would reject txns of that type, compute
    divergent roots, and permanently fall out of consensus while logs
    show only a startup warning."""
    loaded = 0
    for name in modules or ():
        try:
            mod = importlib.import_module(name)
            entry = getattr(mod, ENTRY_POINT, None)
            if entry is None:
                raise PluginLoadError(
                    f"plugin {name} has no {ENTRY_POINT}()")
            entry(node)
        except PluginLoadError:
            raise
        except Exception as exc:  # noqa: BLE001 — plugin code is hostile
            raise PluginLoadError(
                f"plugin {name} failed to load: {exc}") from exc
        loaded += 1
        logger.info("loaded plugin %s", name)
    return loaded
