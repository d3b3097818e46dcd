"""Analysis helpers (port of ``repro.analysis``): the card's roofline
peaks. The JAX package's HLO, lint and model-checker parts are later
slices or have no counterpart here."""
