"""The README's examples on the port (mirroring `examples/`): each runs as
`python -m repro_torch.examples.<name>`, on the card unless `--device
cpu` is asked for."""
