"""Context-parallel matching over a mesh of member devices."""
