"""The card's constants and the roofline of the port's steps."""
