"""Host utilities of the port: the event recorder, scheduling provenance,
the solve watchdog, the chaos injector and the HA fencing token."""
