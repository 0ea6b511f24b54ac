"""Host utilities of the port: the event recorder."""
