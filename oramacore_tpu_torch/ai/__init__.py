"""The port's AI layer, module for module the JAX package's `ai/`: the
sandboxed hooks runtime (`hooks.py`), the LLM client (`llms.py`, its own
HTTP/1.1 client on asyncio streams), the known prompts, the RAG-AT
parser and the constraint extractor, the answer and advanced-autoquery
state machines (`answer.py`, `autoquery.py`), MCP, tools, system
prompts, training sets and accelerator probe, and `service.AIService`,
which wires them to the server's AI routes (`server/__init__.py`)."""
