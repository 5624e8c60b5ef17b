"""State store interface, in-memory store and the relational StateTable."""
