"""K5: the one-launch threefry2x32 draw (`random_bits` / `uniform`,
bitwise jax.random's), which `core.prng` dispatches to on the card."""
