"""Host utilities of the port: the event recorder, scheduling provenance,
the solve watchdog and the chaos injector."""
