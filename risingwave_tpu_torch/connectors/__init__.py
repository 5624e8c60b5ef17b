"""Sources: the vectorized Nexmark bid generator."""
