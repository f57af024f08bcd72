"""Scenario initialization behaviors."""
