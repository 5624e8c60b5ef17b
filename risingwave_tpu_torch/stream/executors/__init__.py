"""Stream executors of the q7-core slice."""
