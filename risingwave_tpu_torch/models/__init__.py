"""Hand-built streaming pipelines (Nexmark q7-core)."""
