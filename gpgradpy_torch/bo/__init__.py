"""Test objectives (the BO loop itself is not ported yet)."""
