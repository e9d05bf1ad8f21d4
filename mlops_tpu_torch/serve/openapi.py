"""The OpenAPI document of the serving API and the Swagger UI page.

A port of the JAX package's ``serve/openapi.py``. The JAX package
generates the request and response schemas from its pydantic wire
models; this package has no pydantic, so ``_applicant_schema`` and
``_output_schemas`` write the same JSON Schema from the feature schema
(``SCHEMA``) directly. ``build_openapi`` returns the JAX document, key for
key.
"""

from __future__ import annotations

from typing import Any

from mlops_tpu_torch import __version__
from mlops_tpu_torch.schema.features import SCHEMA


def _title(name: str) -> str:
    """A field's JSON Schema title as pydantic writes it."""
    return name.title().replace("_", " ")


def _applicant_schema() -> dict[str, Any]:
    """``LoanApplicant``: every feature optional with its schema default."""
    properties: dict[str, Any] = {}
    for feat in SCHEMA.categorical:
        properties[feat.name] = {
            "default": feat.default, "title": _title(feat.name), "type": "string",
        }
    for feat in SCHEMA.numeric:
        properties[feat.name] = {
            "default": float(feat.default), "title": _title(feat.name),
            "type": "number",
        }
    return {
        "description": "Loan applicant record (23 features, schema-generated).",
        "properties": properties,
        "title": "LoanApplicant",
        "type": "object",
    }


def _output_schemas() -> tuple[dict[str, Any], dict[str, Any]]:
    """``(ModelOutput, FeatureBatchDrift)``: the response and its drift
    object, one required number per feature."""
    drift = {
        "description": (
            "Per-feature batch drift score (1 - p_value), one field per "
            "feature."
        ),
        "properties": {
            name: {"title": _title(name), "type": "number"}
            for name in SCHEMA.feature_names
        },
        "required": list(SCHEMA.feature_names),
        "title": "FeatureBatchDrift",
        "type": "object",
    }
    def floats(title: str) -> dict[str, Any]:
        return {"items": {"type": "number"}, "title": title, "type": "array"}

    output = {
        "description": "Response of ``POST /predict`` (parity: `app/model.py:64-70`).",
        "properties": {
            "predictions": floats("Predictions"),
            "outliers": floats("Outliers"),
            "feature_drift_batch": {
                "$ref": "#/components/schemas/FeatureBatchDrift"
            },
        },
        "required": ["predictions", "outliers", "feature_drift_batch"],
        "title": "ModelOutput",
        "type": "object",
    }
    return output, drift


def build_openapi(service_name: str) -> dict[str, Any]:
    """OpenAPI 3.1 document for the serving API."""
    request_schema = {
        "items": {"$ref": "#/components/schemas/LoanApplicant"},
        "type": "array",
    }
    response_schema, drift_schema = _output_schemas()
    components: dict[str, Any] = {
        "LoanApplicant": _applicant_schema(),
        "FeatureBatchDrift": drift_schema,
    }

    return {
        "openapi": "3.1.0",
        "info": {
            "title": service_name,
            "version": __version__,
            "description": (
                "TPU-native credit-default inference service: classifier "
                "+ drift monitor + outlier detector fused into one device "
                "dispatch per request batch."
            ),
        },
        "paths": {
            "/predict": {
                "post": {
                    "summary": "Score loan applicants",
                    "operationId": "predict",
                    "parameters": [
                        {
                            "name": "x-request-deadline-ms",
                            "in": "header",
                            "required": False,
                            "schema": {"type": "integer", "minimum": 1},
                            "description": (
                                "Optional per-request deadline budget in "
                                "milliseconds, measured from request "
                                "admission. The budget decrements across "
                                "admission -> encode -> queue wait -> "
                                "dispatch; any stage finding it spent "
                                "answers 504 WITHOUT doing the remaining "
                                "work (dead-work shedding), and it "
                                "tightens serve.request_timeout_s for "
                                "this request. Malformed values are "
                                "ignored (the header is a hint, not a "
                                "contract)."
                            ),
                        },
                        {
                            "name": "x-request-id",
                            "in": "header",
                            "required": False,
                            "schema": {
                                "type": "string",
                                "pattern": "^[A-Za-z0-9_-]{1,64}$",
                            },
                            "description": (
                                "Caller trace id, echoed on the response "
                                "and in both structured log events; "
                                "minted server-side when absent or "
                                "malformed."
                            ),
                        },
                        {
                            "name": "x-tenant",
                            "in": "header",
                            "required": False,
                            "schema": {
                                "type": "string",
                                "pattern": "^[A-Za-z0-9_-]{1,64}$",
                            },
                            "description": (
                                "Tenant name on a multi-tenant plane "
                                "(serve --tenants tenants.toml): routes "
                                "the request to that tenant's bundle, "
                                "bills its admission quota, and labels "
                                "its metrics/span records. Absent/empty "
                                "= the config-declared default tenant; "
                                "an UNKNOWN name answers 404 (never "
                                "silently billed to the default "
                                "tenant)."
                            ),
                        },
                    ],
                    "requestBody": {
                        "required": True,
                        "content": {
                            "application/json": {"schema": request_schema}
                        },
                    },
                    "responses": {
                        "200": {
                            "description": "Predictions, outlier flags, and per-feature batch drift",
                            "content": {
                                "application/json": {"schema": response_schema}
                            },
                        },
                        "404": {
                            "description": (
                                "Unknown tenant: the x-tenant header "
                                "names no declared tenant. Answered "
                                "before validation or any scoring work "
                                "— nothing was billed to any tenant's "
                                "quota or monitors."
                            )
                        },
                        "422": {"description": "Request body failed validation"},
                        "413": {"description": "Batch exceeds the serving cap"},
                        "503": {
                            "description": (
                                "Load shed (overload): the admission "
                                "queue for the request's bucket class is "
                                "full; the response carries a Retry-After "
                                "header (seconds) and the request was NOT "
                                "scored — retry after the advertised "
                                "delay. During an engine respawn "
                                "(brownout) the same contract applies "
                                "with Retry-After advertising the "
                                "respawn ETA. Deadline exhaustion is a "
                                "504, never a 503."
                            ),
                            "headers": {
                                "Retry-After": {
                                    "description": (
                                        "Seconds to wait before retrying "
                                        "(always present on sheds)"
                                    ),
                                    "schema": {"type": "integer"},
                                }
                            },
                        },
                        "504": {
                            "description": (
                                "Deadline exceeded: the request's "
                                "x-request-deadline-ms budget (or "
                                "serve.request_timeout_s) ran out. "
                                "Distinct from the shed 503: a 504'd "
                                "request MAY have been partially or "
                                "fully scored (the response was simply "
                                "late), so blind retries are not "
                                "idempotency-safe for side-effectful "
                                "callers; no Retry-After is advertised. "
                                "Requests whose budget expired before "
                                "dispatch are shed without device work "
                                "and counted in "
                                "mlops_tpu_deadline_expired_total."
                            )
                        },
                    },
                }
            },
            "/healthz": {
                "get": {
                    "summary": "SLO verdict (sloscope)",
                    "responses": {
                        "200": {
                            "description": (
                                "Serving: verdict 'ok', or 'degraded' "
                                "with the active alerts named (a "
                                "burning error budget means look, not "
                                "pull the instance)."
                            )
                        },
                        "503": {
                            "description": (
                                "verdict 'down': full engine outage or "
                                "never-ready."
                            )
                        },
                    },
                }
            },
            "/healthz/live": {
                "get": {
                    "summary": "Liveness probe",
                    "responses": {"200": {"description": "Process is up"}},
                }
            },
            "/healthz/ready": {
                "get": {
                    "summary": "Readiness probe (bundle loaded + jit warm)",
                    "responses": {
                        "200": {"description": "Ready"},
                        "503": {"description": "Still warming"},
                    },
                }
            },
            "/metrics": {
                "get": {
                    "summary": "Prometheus metrics",
                    "responses": {"200": {"description": "Metrics exposition"}},
                }
            },
        },
        "components": {"schemas": components},
    }


# Self-contained Swagger UI page (assets from the standard CDN — same
# approach FastAPI's bundled docs page uses).
SWAGGER_HTML = """<!doctype html>
<html>
<head>
  <title>{title}</title>
  <meta charset="utf-8"/>
  <link rel="stylesheet"
        href="https://cdn.jsdelivr.net/npm/swagger-ui-dist@5/swagger-ui.css">
</head>
<body>
<div id="swagger-ui"></div>
<script src="https://cdn.jsdelivr.net/npm/swagger-ui-dist@5/swagger-ui-bundle.js"></script>
<script>
  SwaggerUIBundle({{url: "/openapi.json", dom_id: "#swagger-ui"}});
</script>
</body>
</html>"""
