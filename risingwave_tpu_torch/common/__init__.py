"""Foundation: types, chunks, epochs, hashing."""
