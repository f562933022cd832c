"""Stage programs and the in-process state store."""
