"""Lifecycle: the packaging-time gate of the quant student
(``promote.quant_tier_gates``). The closed-loop controller, shadow
serving and hot promotion are not ported (ROADMAP A10)."""
