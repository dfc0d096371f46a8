"""The port's AI layer. It holds the sandboxed hooks runtime
(`hooks.py`) so far; the AI service (LLM answers, tools, system prompts,
training sets) is not ported yet (ROADMAP.md §1), and the server's AI
routes answer 503 as the JAX server does without an AI service."""
