"""Plugin loading: extend a node with new txn types / authenticators.

Reference: plenum/server/plugin/ + the PLUGIN_ROOT loader
(plenum/common/plugin_helper.py). A plugin is an importable module
exposing ``plugin_entry(node)``; at node init every module listed in
``config.PluginModules`` is imported and its entry called with the Node,
which offers the same seams the built-ins use:

- ``node.boot.write_manager.register_req_handler(handler)`` — new write
  txn types (subclass WriteRequestHandler);
- ``node.read_manager`` handlers — new proved-read types;
- ``node.authnr`` / ReqAuthenticator — additional authenticators;
- ``node.internal_bus`` — observe protocol events (Ordered, suspicions).

Copy of ``indy_plenum_tpu/plugins/__init__.py``, with its imports bound to
the port.
"""
from .loader import load_plugins

__all__ = ["load_plugins"]
