"""Bulk scoring on one device (``bulk``); a data mesh is ROADMAP A11."""
