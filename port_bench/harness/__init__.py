"""The benchmark's own machinery: finding cells by name, the closed-loop
window, the device trace and its reduction, the roofline yardstick, and the
check that no JAX module is loaded."""
