"""End-user programs: the monteCarloDriver analog."""
