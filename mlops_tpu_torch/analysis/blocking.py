"""The shared blocking-call classifier (Layers 3 and 5).

ONE table answers "does this call block the calling thread?" for both
consumers: Layer 3 (`concurrency.py` TPU403 — blocking under a held
mutex) and Layer 5 (`asyncdiscipline.py` TPU601 — blocking inside an
event-loop-confined context). The two layers gate different disciplines
but must never disagree about what "blocking" means: a call the lock
layer treats as a stall is a stall on the event loop too, so the table
lives here and both import it.

Layer 5 additionally recognizes the LOOP-context extras (subprocess
waits, synchronous socket operations): a thread stalled in ``recv`` hurts
one thread, but an event loop stalled in it hurts every in-flight
connection on that worker, so the loop context classifies more calls as
blocking — strictly a superset, never a different verdict on the shared
entries.

Pure ``ast`` helpers, no torch import (the Layer 1/3/4 discipline).
"""

from __future__ import annotations

import ast

# Method names that block (or can block) the calling thread. ``join`` is
# special-cased by callers to skip string / path-module receivers.
BLOCKING_METHODS = {
    "block_until_ready",
    "item",
    "tolist",
    "synchronize",  # torch: a device, stream or event wait
    "compile",
    "join",
    "result",
    "wait",
    "put",
    "read_text",
    "read_bytes",
    "write_text",
    "write_bytes",
    "unlink",
    "mkdir",
}
# Dotted-name calls that block or materialize device values on the host.
BLOCKING_CALLS = {
    "np.asarray",
    "np.array",
    "numpy.asarray",
    "numpy.array",
    "onp.asarray",
    "onp.array",
    "jax.device_get",
    "device_get",
    "jax.block_until_ready",
    "torch.cuda.synchronize",
    "time.sleep",
    "subprocess.run",
    "os.replace",
    "open",
}
# ``.join()`` receivers that are string/path helpers, not threads/queues.
JOIN_SAFE_ROOTS = {"os", "posixpath", "ntpath", "str"}
# ``.compile()`` receivers that are regex/builtins, not program builds.
COMPILE_SAFE_ROOTS = {"re"}

# Loop-context extras (TPU601 only): calls a worker THREAD may make
# without stalling anyone else, but an EVENT LOOP must never make
# directly — subprocess waits and synchronous socket operations.
LOOP_BLOCKING_METHODS = {
    "communicate",
    "recv",
    "recv_into",
    "accept",
    "sendall",
    "getaddrinfo",
}
LOOP_BLOCKING_CALLS = {
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.Popen",
    "socket.create_connection",
}


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` attribute chains as a dotted string (None otherwise)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def classify_blocking(
    call: ast.Call, loop_context: bool = False
) -> str | None:
    """A short human label ("``.join()``", "``time.sleep()``") when
    ``call`` is a blocking operation per the shared table, else None.
    ``loop_context`` adds the event-loop-only extras (subprocess waits,
    sync socket ops) to the verdict."""
    func = call.func
    if isinstance(func, ast.Attribute):
        methods = BLOCKING_METHODS | (
            LOOP_BLOCKING_METHODS if loop_context else set()
        )
        if func.attr in methods:
            receiver = dotted(func.value) or ""
            root = receiver.split(".")[0]
            if func.attr == "join" and (
                isinstance(func.value, ast.Constant)
                or root in JOIN_SAFE_ROOTS
            ):
                return None
            if func.attr == "compile" and root in COMPILE_SAFE_ROOTS:
                return None
            return f".{func.attr}()"
        if func.attr == "get" and not call.args and not call.keywords:
            # zero-arg .get(): a blocking queue read (dict.get takes a key)
            return ".get() (blocking queue read)"
    name = dotted(func) or ""
    calls = BLOCKING_CALLS | (LOOP_BLOCKING_CALLS if loop_context else set())
    if name in calls:
        return f"{name}()"
    return None
