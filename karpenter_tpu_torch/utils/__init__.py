"""Host utilities of the port: the event recorder, scheduling provenance
and the solve watchdog."""
