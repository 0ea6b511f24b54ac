"""Controllers of the port: the consolidation decision."""
