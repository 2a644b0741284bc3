"""The operations a traffic mix drives, one module each, found by the
mix's "op": `warm(cell)`, `window(cell, clock) -> Outcome`,
`k1_bytes(run)` and `check(cell, outcome) -> {name: (value, limit)}`.
"""
