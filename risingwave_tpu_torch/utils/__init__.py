"""Device placement, host<->device transfers and kernel launch counts."""
