"""NDArray subset of the port: the container reader."""
