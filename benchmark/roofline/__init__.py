"""The line-sum kernels' bound, counted from the inputs."""
