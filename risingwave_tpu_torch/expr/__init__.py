"""Host (numpy) expressions: column refs, literals, tumble_start."""
