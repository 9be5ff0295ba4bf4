"""Query lowering, staging onto the card, and the Count serving layer."""
