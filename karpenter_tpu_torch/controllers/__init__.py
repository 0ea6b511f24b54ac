"""Controllers of the port: provisioning and the consolidation decision."""
