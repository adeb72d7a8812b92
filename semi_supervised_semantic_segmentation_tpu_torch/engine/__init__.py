"""Training engine: optimizer/EMA state, weight interop, trainer."""
