"""Model zoo (ported so far: the long-context document BERT)."""
