"""Training-side helpers (ported so far: document grouping and the dense
``build_doc_model``)."""
