"""Roofline of a dry-run cell on the H100 (counterpart of repro/roofline):
`analysis` counts a traced step and prices it, `report` prints the
tables of a dry-run's reports."""
