"""Traffic drivers: one module per kind of loop, named by a traffic mix's
`driver`."""
