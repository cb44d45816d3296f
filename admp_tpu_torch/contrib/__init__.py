"""Optional adapters to other packages (each behind an import guard)."""
