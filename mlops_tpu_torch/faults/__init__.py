"""Deterministic fault injection (``faults.fire`` / ``faults.corrupt``),
the port's copy of the JAX package's ``faults/``.

    from mlops_tpu_torch import faults
    faults.fire("serve.engine.dispatch")

``injector.py`` has the plan format and semantics. ``POINTS`` lists every
point compiled into the port, with the modes that make sense there: every
point of the JAX package. ``UNPORTED_POINTS`` would name a JAX point the
port lacked and the ROADMAP item bringing it; it is empty.
"""

from mlops_tpu_torch.faults.injector import (  # noqa: F401
    ENV_VAR,
    FAULT_MODES,
    FaultInjected,
    FaultPlan,
    FaultRule,
    active_plan,
    arm,
    armed,
    corrupt,
    disarm,
    fire,
    load_plan,
)

POINTS: dict[str, str] = {
    "serve.engine.dispatch": "before every solo dispatch, on the host before the "
    "graph replay (raise = device error -> 500; delay = engine stall -> deadline 504)",
    "serve.engine.dispatch_group": "before every grouped dispatch (same modes; "
    "covers the micro-batcher and the ring plane)",
    "serve.frontend.predict": "a ring front end's predict entry (kill = worker "
    "crash mid-request; the supervisor's respawn path)",
    "serve.engine.exit": "each tick of the engine process's main loop (kill = "
    "engine death -> supervisor respawn, brownout; raise = main-loop failure, "
    "same recovery)",
    "serve.engine.compile": "before a dispatch readies a shape warmup did not "
    "(the card's graph capture; raise = a failed capture -> the degraded fallback "
    "through the next larger ready shape of the tier, counted)",
    "serve.ring.reattach": "entry of a respawned engine's ring re-attach (delay = "
    "a slow re-attach; raise = failed re-attach -> the engine exits, the "
    "supervisor retries)",
    "compilecache.read": "a kernel library's bytes read for their sha256 check "
    "(corrupt = bit flips -> counted discard + nvcc rebuild)",
    "compilecache.persist.midwrite": "between a kernel library's tmp write and its "
    "rename (kill = torn persist; no partial library may survive)",
    "lifecycle.reservoir.midwrite": "between the reservoir snapshot's tmp write "
    "and its rename (kill = torn reservoir save)",
    "io.atomic_write.midwrite": "inside utils.io.atomic_write between write and "
    "rename (kill = torn checkpoint or registry write)",
    "lifecycle.retrain": "entry of the controller's retrain transition (raise = "
    "repeated retrain failure -> circuit breaker)",
    "lifecycle.shadow.evaluate": "entry of the shadow gate evaluation (raise = "
    "repeated evaluation failure -> circuit breaker)",
    "autotune.regrid.midswap": "between a regrid's warm phase and its bucket-set "
    "swap (kill = crashed apply at maximum in-flight state: the generation keeps "
    "only valid captured graphs, serving continues on the old grid, and a "
    "restarted plane re-plans cleanly)",
}

# JAX points whose code path the port does not have yet, and the ROADMAP
# item that brings each with it: none.
UNPORTED_POINTS: dict[str, str] = {}
