"""Tools that set the benchmark's data: frozen work counts, check limits."""
