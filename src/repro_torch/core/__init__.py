"""Pipeline schedule compiler (pure Python copy of ``repro.core.pipeline``)."""
