"""Distribution plan and gradient synchronization of the port."""
