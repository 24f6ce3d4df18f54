"""K2: the full-iteration COKE/DKLA megakernel (`coke_megastep`)."""
