"""Data pipeline (mirrors ``repro/data``); the tokenizer comes with a later
slice."""
