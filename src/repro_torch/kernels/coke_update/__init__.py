"""K2, the full-iteration COKE/DKLA megakernel (`coke_megastep`), and K3,
the ring runtime's fused consensus combine (`coke_fused_update`)."""
