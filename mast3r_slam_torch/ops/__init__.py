"""Device ops of the port: the attention kernel, the dense matcher, the pose
Gauss-Newton and its Cholesky solve."""
