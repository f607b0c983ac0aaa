"""The Monte Carlo solver: fastpath planner and trace loop, results, Integrator."""
