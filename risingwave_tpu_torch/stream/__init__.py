"""Stream runtime: messages, executors, exchange channels, actors."""
