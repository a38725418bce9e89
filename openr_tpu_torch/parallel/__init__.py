"""Whole-fabric RIBs on the solver's card (``sharding.py``); the
cross-card split of the reference's mesh is not ported yet."""
