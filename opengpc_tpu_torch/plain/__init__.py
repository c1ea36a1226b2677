"""Plain PyTorch references of the port's matching, written from the
method's description with ordinary tensor operations and none of the
port's kernels, matchers or routes, for the tests to hold the port to."""
