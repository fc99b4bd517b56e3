"""Plain helpers shared by the port (logging, stage timers)."""
