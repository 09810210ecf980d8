"""Edge accumulation and the host-side graph metrics and clustering."""
